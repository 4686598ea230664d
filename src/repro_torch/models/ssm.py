"""Mamba2 (SSD) layer of the port: the ``zamba`` family's backbone.

Counterparts of ``repro.models.ssm``: ``ssm_dims`` (:25), ``ssm_specs``
(:31, as the :class:`SSM` module), ``_proj`` (:51), ``ssm_block`` (:69),
``ssm_decode`` (:129) and ``ssm_init_state`` (:149). Layout as there:
d_inner = expand * d_model, nh = d_inner / ssm_head_dim heads, a scalar
decay per head and one B/C group shared by the heads.

Prefill runs the scan through ``kernels.ssm_scan`` (the CUDA kernel on
the card), which also returns the final state for the decode cache; the
B/C projections go to it once per sequence, not once per head. The
one-token decode update stays plain PyTorch, as JAX computes it outside
any Pallas kernel. Both norms (``norm`` and ``out_norm`` over d_inner)
go through ``kernels.fused_rmsnorm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.ssm_scan import chunk_cumsum
from .layers import _param, mm, rmsnorm


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state


class SSM(nn.Module):
    """Parameters of one Mamba2 layer (``ssm_specs``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        d_in, nh, _, ds = ssm_dims(cfg)
        f32 = torch.float32
        self.w_xz = _param((d, 2 * d_in), dtype, device)
        self.w_B = _param((d, ds), dtype, device)
        self.w_C = _param((d, ds), dtype, device)
        self.w_dt = _param((d, nh), dtype, device)
        self.dt_bias = _param((nh,), f32, device)
        self.A_log = _param((nh,), f32, device)
        self.D = _param((nh,), f32, device)
        self.w_out = _param((d_in, d), dtype, device)
        self.norm = _param((d,), f32, device)
        self.out_norm = _param((d_in,), f32, device)


def _proj(p: SSM, x: torch.Tensor, cfg: ModelConfig, kernels):
    """Shared projections. Returns xbar (B, S, nh, hd) f32, xh, z, B_, C_
    (compute dtype) and loga (B, S, nh) f32."""
    _, nh, hd, _ = ssm_dims(cfg)
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    xin, z = mm(h, p.w_xz).chunk(2, dim=-1)
    B_ = mm(h, p.w_B)                                   # (B, S, ds)
    C_ = mm(h, p.w_C)
    dt = F.softplus(mm(h, p.w_dt) + p.dt_bias)           # (B, S, nh) f32
    loga = dt * -torch.exp(p.A_log.float())             # log decay, <= 0
    xh = xin.reshape(x.shape[0], x.shape[1], nh, hd)
    xbar = xh.float() * dt[..., None]                   # Mamba2 x * dt
    return xbar, xh, z, B_, C_, loga


def _out(p: SSM, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
         x: torch.Tensor, cfg: ModelConfig, kernels) -> torch.Tensor:
    """Skip term, gated output norm and out-projection; y (B, S, nh, hd)."""
    B, S = x.shape[:2]
    y = y + xh.float() * p.D[:, None]
    y = rmsnorm(y.reshape(B, S, -1).to(x.dtype), p.out_norm, cfg.norm_eps,
                kernels=kernels)
    return mm(y * F.silu(z), p.w_out)


def ssm_block(p: SSM, x: torch.Tensor, cfg: ModelConfig, *,
              kernels=ops) -> tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill from the zero state: x (B, S, d). Returns (out, h)
    with the final state h (B, nh, hd, ds) f32. The chunk is
    ``min(ssm_chunk, S)`` as in JAX; the scan takes a short last chunk
    where JAX pads with zero inputs and zero log-decay (the same
    function)."""
    B, S, _ = x.shape
    _, nh, hd, ds = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    xbar, xh, z, B_, C_, loga = _proj(p, x, cfg, kernels)
    cum = chunk_cumsum(loga.transpose(1, 2).reshape(B * nh, S), Q)
    y, h = kernels.ssm_scan(
        xbar.transpose(1, 2).reshape(B * nh, S, hd).contiguous(),
        B_.contiguous(), C_.contiguous(), cum, chunk=Q)
    y = y.view(B, nh, S, hd).transpose(1, 2)
    return _out(p, y, xh, z, x, cfg, kernels), h.view(B, nh, hd, ds)


def ssm_decode(p: SSM, x: torch.Tensor, cfg: ModelConfig, h: torch.Tensor,
               *, kernels=ops) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update: x (B, 1, d), h (B, nh, hd, ds) f32.
    Returns (out, new h)."""
    xbar, xh, z, B_, C_, loga = _proj(p, x, cfg, kernels)
    a = torch.exp(loga[:, 0])                           # (B, nh)
    h = h * a[:, :, None, None] + \
        xbar[:, 0, :, :, None] * B_[:, 0].float()[:, None, None, :]
    y = (h @ C_[:, 0].float()[:, None, :, None])[..., 0]     # (B, nh, hd)
    return _out(p, y[:, None], xh, z, x, cfg, kernels), h


def ssm_init_state(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    _, nh, hd, ds = ssm_dims(cfg)
    return torch.zeros(batch, nh, hd, ds, dtype=torch.float32, device=device)
