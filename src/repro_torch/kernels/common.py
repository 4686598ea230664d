"""Checks shared by the kernel wrappers before a pointer reaches CUDA, the
meta route: on a meta tensor a wrapper allocates what its CUDA call
allocates, then skips the launch (:func:`skip_launch`), and the sharded
route: on DTensors a wrapper runs on each rank's shards
(:func:`on_shards`)."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Sequence

import torch

from . import costs

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the two attention kernels (168: gemma3-27b, padded to 176
#: inside the bf16 flash kernel; 240: gemma3-12b)
HEAD_DIMS = (16, 32, 64, 128, 168, 240)
#: head dims of the rwkv6_scan kernel
SCAN_HEAD_DIMS = (16, 32, 64, 128)


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def check_cuda_tensor(t: torch.Tensor, name: str, arg: str) -> None:
    require(t.is_cuda, name, f"{arg} must be a CUDA tensor, got {t.device}")
    require(t.is_contiguous(), name, f"{arg} must be contiguous")
    require(t.device.index == torch.cuda.current_device(), name,
            f"{arg} is on {t.device}, not the current device")


def check_kernel_tensor(t: torch.Tensor, name: str, arg: str,
                        like: torch.Tensor) -> None:
    """:func:`check_cuda_tensor`, which a meta tensor also passes: the dry
    run's route through a wrapper (no pointer reaches CUDA). ``like`` is
    the input that decides the route (:func:`skip_launch`'s): every
    argument must lie on its device, so a meta argument (data pointer 0)
    never reaches a launch on the card, nor a CUDA one a skipped launch."""
    require(t.device == like.device, name,
            f"{arg} is on {t.device}, not on {like.device} as the other inputs")
    if t.is_meta:
        require(t.is_contiguous(), name, f"{arg} must be contiguous")
    else:
        check_cuda_tensor(t, name, arg)


def skip_launch(t: torch.Tensor, name: str,
                cost: Callable[[], costs.Cost]) -> bool:
    """True where ``t`` is a meta tensor: the kernel ``name`` is not
    launched (nor counted as launched), and its ``cost()`` is recorded
    (``costs.record``). False on the card, where nothing else is done."""
    if not t.is_meta:
        return False
    costs.record(name, cost())
    return True


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel with no backward raises where a gradient is wanted: its
    output would carry no ``grad_fn`` and training would silently lose
    the gradients of everything before it."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; a gradient "
            "through it is not supported on the card")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy of it where its data is not 16-byte aligned
    (for kernels that stage rows with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_LOCAL_CALLS: Optional[list] = None


@contextmanager
def local_calls() -> Iterator[list]:
    """Inside the block, each :func:`on_shards` call appends ``(name,
    ((local shape, dtype name) of each argument), (its keywords as sorted
    (name, value) pairs))`` to the yielded list."""
    global _LOCAL_CALLS
    prev, _LOCAL_CALLS = _LOCAL_CALLS, []
    try:
        yield _LOCAL_CALLS
    finally:
        _LOCAL_CALLS = prev


def note_call(name: str, args: Sequence[torch.Tensor], kw: dict) -> None:
    """Appends a kernel's local call to the open :func:`local_calls` list
    (nothing outside one)."""
    if _LOCAL_CALLS is not None:
        _LOCAL_CALLS.append((name, tuple(
            (tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for a in args), tuple(sorted(kw.items()))))


def on_shards(name: str, fn: Callable, args: Sequence, *,
              whole: Sequence[Sequence[int]], kw: Optional[dict] = None,
              outs: Optional[Sequence[tuple]] = None,
              cut: Optional[Callable] = None):
    """``fn(*local shards, **kw)`` on this rank's shards of the DTensors
    ``args``: the local call takes the wrapper's own route (kernel, meta
    or plain) on local tensors, and no collective runs
    (``sharding.on_local``). Its output is a DTensor of ``args[0]``'s
    shape and placements, contiguous; with ``outs``, one ``(global
    shape, placements)`` an output, a tuple of them. ``whole[i]`` are
    the dims of ``args[i]`` a kernel must see whole (a norm's rows,
    attention's sequence and head dims): an argument split on one of
    them, or a partial sum, raises, as does a split that does not divide
    its dim (the shards' shapes would differ). An argument replicated
    where an output is split (a norm's weight) takes a partial gradient,
    reduced where it is used. ``cut(*local shards)``, where given, returns
    the local tensors the kernel is called on (attention's own KV head
    of a replicated k and v)."""
    from torch.distributed.tensor import DTensor

    from ..distributed.sharding import on_local
    mesh = args[0].device_mesh
    for i, (a, keep) in enumerate(zip(args, whole, strict=True)):
        require(isinstance(a, DTensor) and a.device_mesh == mesh, name,
                f"argument {i} is not a DTensor on {mesh}")
        kept = {k % a.ndim for k in keep}
        require(not any(p.is_partial() for p in a.placements), name,
                f"argument {i} is a partial sum ({a.placements})")
        split = {p.dim % a.ndim for p in a.placements if p.is_shard()}
        require(not split & kept, name,
                f"argument {i} of shape {tuple(a.shape)} is split on dims "
                f"{sorted(split & kept)} ({a.placements}), which the kernel "
                "takes whole")
        uneven = [p.dim for m, p in enumerate(a.placements) if p.is_shard()
                  and a.shape[p.dim] % mesh.size(m)]
        require(not uneven, name,
                f"argument {i} of shape {tuple(a.shape)} is split unevenly "
                f"on dims {uneven} ({a.placements})")
    kw = kw or {}

    def local(*shards):
        if cut is not None:
            shards = cut(*shards)
        note_call(name, shards, kw)
        return fn(*shards, **kw)
    like = args[0]
    got = on_local(local, args, outs or ((like.shape,
                                          tuple(like.placements)),))
    return got if outs else got[0]
