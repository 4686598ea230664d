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

The sharded step runs on a ``torch.distributed`` ``DeviceMesh`` over a
mesh (:func:`device_mesh`), which needs a process group of the mesh's
size. :func:`fake_group` is a measuring device, not a group to train
on: one rank of a mesh runs alone and its collectives move no data, so
the dry run reckons a rank's memory, flops and collectives on the meta
device, and one card holds rank 0's footprint. No entry point uses it
in place of a real group.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence

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
#: cuBLAS's workspace, which torch allocates through the caching
#: allocator at a thread's first matmul on the card and keeps (sm_90's
#: default; measured at the first matmul of the forward's and of
#: autograd's device thread)
CUBLAS_WORKSPACE = 32 * 2**20

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


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``device_type`` over ``mesh``'s layout, rank r
    at r's place in row-major order, its dims named as the mesh's axes
    (``data``, ``model``). The default process group must be up, of the
    mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"a {mesh.shape} device mesh needs a process "
                           f"group of {mesh.size} ranks")
    ranks = torch.arange(mesh.size).reshape(mesh.devices.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)


@contextmanager
def fake_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """Inside the block the default process group is ``torch``'s fake
    one: this process is ``rank`` of ``world_size``, and a collective
    allocates its output and moves nothing (values after it are
    garbage). ``init_process_group`` is global to a process: start the
    block where no group is up, best in a fresh process; it is torn down
    on exit."""
    import torch.distributed as dist
    # registers the "fake" backend for cpu and cuda
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
