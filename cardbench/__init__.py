"""The benchmark of the PyTorch and CUDA port (``repro_torch``): hybrid
slot-scheduled LLM serving on one NVIDIA H100, driven by the cells of
``BENCHMARK.json`` at the root of the checkout.

Run one cell once, from the root of a checkout::

    python3 cardbench/run.py --workload deepseek-7b.conv.closed \\
        --seed 7 --seconds 45 --trace 0
"""
