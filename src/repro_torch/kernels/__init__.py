"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a),
each with its plain PyTorch version beside it in its module.

:mod:`.ops` dispatches by device (CUDA tensor: kernel; CPU tensor: plain
version); :mod:`.plain` gives the plain versions under the same names.
"""
from . import ops, plain

__all__ = ["ops", "plain"]
