"""The H100's roofline constants and the dry run's device meshes
(counterpart of ``repro.launch.mesh``).

The constants are the one source of every bound the port states
(``kernels.costs``, ``launch.dryrun``, ``chip_smoke.py``): the rates are
NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense without
sparsity; the memory is the card's as measured on it (``HBM_USABLE``,
what one step may allocate, is the capacity less what the allocator
cannot use).

A mesh is a layout of devices, not an allocation: :func:`make_mesh`
names ``torch.device("cuda", i)`` objects and touches no device, so the
dry run reckons a four-card cell on a host with none. The presets stand
in for JAX's TPU meshes (a 16 x 16 pod, two of them): ``single`` is one
card, ``quad`` one data row over four model-parallel cards, the four
NVLink-joined cards of one host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..distributed.sharding import Mesh

PEAK_FLOPS_BF16 = 989e12        # bf16 tensor cores, FLOP/s
PEAK_FLOPS_TF32 = 495e12        # TF32 tensor cores
PEAK_FLOPS_F32 = 67e12          # f32 on the CUDA cores
HBM_BW = 3.35e12                # bytes/s of HBM3
NVLINK_BW = 450e9               # bytes/s a direction, NVLink 4 (18 links)
#: the card's memory as torch reports it (``total_memory`` of one "NVIDIA
#: H100 80GB HBM3"; ``chip_smoke.py`` fails where the card differs)
HBM_BYTES = 85_017_493_504
#: held outside the caching allocator: the CUDA context, the kernels'
#: module and the libraries' handles (0.55 GB idle, 0.81 GB in a train
#: step, measured; ``chip_smoke.py`` fails at a train cell above it)
HBM_OUTSIDE_ALLOCATOR = 1_000_000_000
#: blocks the caching allocator holds but cannot hand out at a step's
#: peak (2.5-4.1 GB reserved beyond max_memory_allocated at the deepest
#: train cells that ran; the next layer failed with 2.9-5.4 GB so held)
HBM_SPLIT_SLACK = 4_000_000_000
#: what a step's max_memory_allocated may reach: the dry run's ``fits``
HBM_USABLE = HBM_BYTES - HBM_OUTSIDE_ALLOCATOR - HBM_SPLIT_SLACK

#: preset name -> (data, model)
MESHES = {"single": (1, 1), "quad": (1, 4)}


def make_mesh(data: int, model: int,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: CUDA devices 0 ..
    data * model - 1, named, not opened)."""
    n = data * model
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"a {data} x {model} mesh needs {n} devices, "
                         f"got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = list(devices)
    return Mesh(grid.reshape(data, model), ("data", "model"))


def mesh_preset(name: str) -> Mesh:
    if name not in MESHES:
        raise KeyError(f"mesh {name!r}: one of {sorted(MESHES)}")
    return make_mesh(*MESHES[name])
