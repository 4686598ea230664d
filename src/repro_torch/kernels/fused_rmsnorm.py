"""RMSNorm with a ``(1 + w)`` scale: ``x * rsqrt(mean(x^2) + eps) * (1 + w)``
in f32, cast to x's dtype.

Port of the Pallas TPU kernel ``src/repro/kernels/fused_rmsnorm.py:19``.
:func:`fused_rmsnorm_plain` is the plain PyTorch version (the semantics of
``repro.kernels.ref.fused_rmsnorm_ref``); :func:`fused_rmsnorm_cuda`
launches the hand-written kernel ``csrc/fused_rmsnorm.cu``.
"""
from __future__ import annotations

import torch

from . import build
from .common import DTYPE_CODES, check_cuda_tensor, require, stream_of

NAME = "fused_rmsnorm"
launches = 0


def fused_rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *,
                        eps: float = 1e-6) -> torch.Tensor:
    """x: (N, d); w: (d,)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def fused_rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """x: (N, d) bf16/f32 contiguous on the card; w: (d,) f32."""
    global launches
    check_cuda_tensor(x, NAME, "x")
    check_cuda_tensor(w, NAME, "w")
    require(x.dim() == 2, NAME, f"x must be (N, d), got {tuple(x.shape)}")
    require(x.dtype in DTYPE_CODES, NAME, f"x dtype {x.dtype} not supported")
    require(w.dtype == torch.float32, NAME, "w must be float32")
    n, d = x.shape
    require(w.shape == (d,), NAME, f"w must be ({d},), got {tuple(w.shape)}")
    require(n >= 1 and d >= 1, NAME, "empty input")
    out = torch.empty_like(x)
    rc = build.library().repro_fused_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, eps,
        DTYPE_CODES[x.dtype], stream_of(x))
    build.check(rc, NAME)
    launches += 1
    return out
