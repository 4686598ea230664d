"""Mamba2 (SSD) layer of the port: the ``zamba`` family's backbone.

Counterparts of ``repro.models.ssm``: ``ssm_dims`` (:25), ``ssm_specs``
(:31, as the :class:`SSM` module), ``_proj`` (:51), ``ssm_block`` (:69),
``ssm_decode`` (:129) and ``ssm_init_state`` (:149). Layout as there:
d_inner = expand * d_model, nh = d_inner / ssm_head_dim heads, a scalar
decay per head and one B/C group shared by the heads.

Prefill runs the scan through ``kernels.ssm_scan`` (the CUDA kernel on
the card), which also returns the final state for the decode cache; the
B/C projections go to it once per sequence, not once per head. From a
carried state ``h`` (JAX's ``state["h"]``) the scan still starts from
zero, and the state's share, linear in it, is added around it with
torch ops (:func:`_from_state`). The
one-token decode update stays plain PyTorch, as JAX computes it outside
any Pallas kernel. Both norms (``norm`` and ``out_norm`` over d_inner)
go through ``kernels.fused_rmsnorm``.

On DTensors (the sharded step) the scan runs on each rank's heads
(:func:`ssm_block`), the norms on whole rows, and the decode update on
the whole state, which JAX's cache spec replicates over the heads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import is_dtensor, shard
from ..kernels import ops
from ..kernels.ssm_scan import chunk_cumsum
from .layers import _param, carried_state, mm, rmsnorm


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
    """Shared projections. Returns xh (B, S, nh, hd), z, B_, C_ (compute
    dtype) and dt (B, S, nh) f32. On DTensors each is whole on the model
    axis: ``w_xz``'s columns are split there (``"mlp"``), so xin's half
    lies on one half of the ranks and z's on the other, and xz is
    gathered (one all-gather a layer); the scan then cuts its inputs to
    each rank's heads (:func:`ssm_block`)."""
    _, nh, hd, _ = ssm_dims(cfg)
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    xin, z = shard(mm(h, p.w_xz), "batch", "seq", None).chunk(2, dim=-1)
    B_ = mm(h, p.w_B)                                   # (B, S, ds)
    C_ = mm(h, p.w_C)
    dt = F.softplus(mm(h, p.w_dt) + p.dt_bias)           # (B, S, nh) f32
    xh = xin.reshape(x.shape[0], x.shape[1], nh, hd)
    return xh, z, B_, C_, dt


def _weighted(p: SSM, xh: torch.Tensor, dt: torch.Tensor):
    """xbar (B, S, nh, hd) f32, Mamba2's x * dt, and the log decay loga
    (B, S, nh) f32, <= 0."""
    return xh.float() * dt[..., None], dt * -torch.exp(p.A_log.float())


def _out(p: SSM, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
         x: torch.Tensor, cfg: ModelConfig, kernels) -> torch.Tensor:
    """Skip term, gated output norm and out-projection; y (B, S, nh, hd).
    On DTensors the norm takes its rows whole (y gathered over the
    heads), the gated rows are cut to ``w_out``'s row split, and the
    out-projection's partial sum is reduced at JAX's constraint
    (``ssm.py:126``)."""
    B, S = x.shape[:2]
    y = y + xh.float() * p.D[:, None]
    y = rmsnorm(shard(y.reshape(B, S, -1).to(x.dtype), "batch", "seq", None),
                p.out_norm, cfg.norm_eps, kernels=kernels)
    y = shard(y, "batch", "seq", "mlp") * F.silu(shard(z, "batch", "seq",
                                                       "mlp"))
    return shard(mm(y, p.w_out), "batch", "seq", None)


def _from_state(y, last, h, loga, C):
    """The carried state's share of a sequence (the recurrence is linear
    in it): with Λ_t the inclusive running sum of ``loga`` (B, nh, S) over
    the whole sequence (no reset a chunk; <= 0), y_t (B, nh, S, hd) gains
    exp(Λ_t) h C_t^T and the final state exp(Λ_{S-1}) h."""
    h = h.to(y.dtype)                   # the scan's dtype, as JAX's state
    lam = torch.cumsum(loga, dim=-1)
    y = y + torch.exp(lam)[..., None] * torch.einsum(
        "bnhs,bts->bnth", h, C.to(y.dtype))
    return y, last + torch.exp(lam[..., -1])[..., None, None] * h


def ssm_block(p: SSM, x: torch.Tensor, cfg: ModelConfig, *,
              h: Optional[torch.Tensor] = None,
              kernels=ops) -> tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill: x (B, S, d), from the zero state or, given ``h`` (B,
    nh, hd, ds) f32, from that state (JAX's ``state={"h": h}``). Returns
    (out, h) with the final state h (B, nh, hd, ds) f32. The chunk is
    ``min(ssm_chunk, S)`` as in JAX; the scan takes a short last chunk
    where JAX pads with zero inputs and zero log-decay (the same
    function). With ``h=None`` nothing is added to the zero-state scan.
    On DTensors the scan runs on each rank's heads (its inputs cut to
    them, B_ and C_ shared by them) and h keeps that split, as do the
    carried state's terms."""
    B, S, _ = x.shape
    _, nh, hd, ds = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    xh, z, B_, C_, dt = _proj(p, x, cfg, kernels)
    xh = shard(xh, "batch", "seq", "heads", None)
    xbar, loga = _weighted(p, xh, shard(dt, "batch", "seq", "heads"))
    xbar = xbar.transpose(1, 2).contiguous()            # (B, nh, S, hd)
    loga = loga.transpose(1, 2)                         # (B, nh, S)
    cum = chunk_cumsum(loga, Q)
    if is_dtensor(xbar):
        # the heads kept as a dim: one flat (B * nh) dim could not keep
        # batch and heads both split
        y, last = kernels.ssm_scan(xbar, B_, C_, cum, chunk=Q)
    else:
        y, last = kernels.ssm_scan(xbar.view(B * nh, S, hd),
                                   B_.contiguous(), C_.contiguous(),
                                   cum.view(B * nh, S), chunk=Q)
        y, last = y.view(B, nh, S, hd), last.view(B, nh, hd, ds)
    if h is not None:
        y, last = carried_state(_from_state, y, last, h, steps=(loga,),
                                shared=(C_,))
    return _out(p, y.transpose(1, 2), xh, z, x, cfg, kernels), last


def ssm_decode(p: SSM, x: torch.Tensor, cfg: ModelConfig, h: torch.Tensor,
               *, kernels=ops) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update: x (B, 1, d), h (B, nh, hd, ds) f32.
    Returns (out, new h). On DTensors h is whole on the model axis (JAX's
    cache spec replicates the heads), and so is the update."""
    xh, z, B_, C_, dt = _proj(p, x, cfg, kernels)
    xbar, loga = _weighted(p, xh, dt)
    a = torch.exp(loga[:, 0])                           # (B, nh)
    f = xbar.dtype                      # f32 (f64 where the model runs in f64)
    h = h * a[:, :, None, None] + \
        xbar[:, 0, :, :, None] * B_[:, 0].to(f)[:, None, None, :]
    y = (h @ C_[:, 0].to(f)[:, None, :, None])[..., 0]      # (B, nh, hd)
    return _out(p, y[:, None], xh, z, x, cfg, kernels), h


def ssm_init_state(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    _, nh, hd, ds = ssm_dims(cfg)
    return torch.zeros(batch, nh, hd, ds, dtype=torch.float32, device=device)
