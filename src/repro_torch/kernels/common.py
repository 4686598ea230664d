"""Checks shared by the kernel wrappers before a pointer reaches CUDA, and
the meta route: on a meta tensor a wrapper allocates what its CUDA call
allocates, then skips the launch (:func:`skip_launch`)."""
from __future__ import annotations

from typing import Callable

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
