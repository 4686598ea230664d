"""repro_torch — the PyTorch/CUDA port of the real-model serving path.

Runs on one NVIDIA Hopper card by default (``device="cpu"`` selects the
plain PyTorch versions of the kernels, as the tests do). The package
imports neither ``jax`` nor anything of ``repro``: the few framework-free
pieces it needs from the JAX package are kept here as own copies.
"""
