"""RMSNorm with a ``(1 + w)`` scale: ``x * rsqrt(mean(x^2) + eps) * (1 + w)``
in f32, cast to x's dtype.

Port of the Pallas TPU kernel ``src/repro/kernels/fused_rmsnorm.py:19``.
:func:`fused_rmsnorm_plain` is the plain PyTorch version (the semantics of
``repro.kernels.ref.fused_rmsnorm_ref``); :func:`fused_rmsnorm_cuda`
launches the hand-written kernel ``csrc/fused_rmsnorm.cu``. Where autograd
records the call, it goes through :class:`FusedRMSNorm`, whose backward
is the hand-written ``repro_fused_rmsnorm_bwd`` (dx in x's dtype, dw in
f32: a partial row for each block of contiguous rows, at most
``BWD_BLOCKS`` of them, summed in a fixed order);
:func:`fused_rmsnorm_bwd_plain` is autograd through the plain version.
"""
from __future__ import annotations

import torch

from . import build, costs
from .common import (DTYPE_CODES, check_kernel_tensor, needs_grad, require,
                     skip_launch, stream_of)

NAME = "fused_rmsnorm"
BWD_NAME = "fused_rmsnorm_bwd"
BWD_BLOCKS = 264      # most blocks of the backward's row pass (csrc kBwdBlocks)
launches = 0
bwd_launches = 0


def fused_rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *,
                        eps: float = 1e-6) -> torch.Tensor:
    """x: (N, d); w: (d,)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    check_kernel_tensor(x, NAME, "x", x)
    check_kernel_tensor(w, NAME, "w", x)
    require(x.dim() == 2, NAME, f"x must be (N, d), got {tuple(x.shape)}")
    require(x.dtype in DTYPE_CODES, NAME, f"x dtype {x.dtype} not supported")
    require(w.dtype == torch.float32, NAME, "w must be float32")
    n, d = x.shape
    require(w.shape == (d,), NAME, f"w must be ({d},), got {tuple(w.shape)}")
    require(n >= 1 and d >= 1, NAME, "empty input")


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    _check(x, w)
    n, d = x.shape
    out = torch.empty_like(x)
    if skip_launch(x, NAME, lambda: costs.rmsnorm(n, d, x.dtype)):
        return out
    rc = build.library().repro_fused_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, eps,
        DTYPE_CODES[x.dtype], stream_of(x))
    build.check(rc, NAME)
    launches += 1
    return out


class FusedRMSNorm(torch.autograd.Function):
    """The kernel with the hand-written backward (x and w saved)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = fused_rmsnorm_bwd_cuda(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


def fused_rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """x: (N, d) bf16/f32 contiguous on the card; w: (d,) f32."""
    if needs_grad(x, w):
        return FusedRMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


def fused_rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                            dy: torch.Tensor, *, eps: float = 1e-6
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw): autograd through :func:`fused_rmsnorm_plain`."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        dx, dw = torch.autograd.grad(fused_rmsnorm_plain(xg, wg, eps=eps),
                                     (xg, wg), dy)
    return dx, dw


def fused_rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor, *, eps: float = 1e-6
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw f32) for the output gradient dy (x's shape
    and dtype, contiguous): one launch of the rows pass and the dw pass."""
    global bwd_launches
    _check(x, w)
    check_kernel_tensor(dy, BWD_NAME, "dy", x)
    require(dy.shape == x.shape and dy.dtype == x.dtype, BWD_NAME,
            "dy must have x's shape and dtype")
    n, d = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((BWD_BLOCKS, d), dtype=torch.float32,
                          device=x.device)
    if skip_launch(x, BWD_NAME, lambda: costs.rmsnorm_bwd(n, d, x.dtype)):
        return dx, dw
    rc = build.library().repro_fused_rmsnorm_bwd(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), n, d, eps, DTYPE_CODES[x.dtype],
        stream_of(x))
    build.check(rc, BWD_NAME)
    bwd_launches += 1
    return dx, dw
