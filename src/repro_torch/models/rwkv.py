"""RWKV6 ("Finch") layer of the port: the ``rwkv`` family.

Counterparts of ``repro.models.rwkv``: ``rwkv_dims`` (:26), ``rwkv_specs``
(:31, as the :class:`RWKV` module), ``_token_shift`` (:67), ``_lerp``
(:72), ``_time_mix_projections`` (:80), ``rwkv_time_mix`` (:101),
``rwkv_channel_mix`` (:195), ``rwkv_block`` (:207) and
``rwkv_init_state`` (:218).

Prefill (a sequence from the zero state, any length) runs the recurrence
through ``kernels.rwkv6_scan`` (the CUDA kernel on the card), which also
returns the final state. JAX uses a chunked-parallel form when S is a
multiple of 16 and the sequential form otherwise; both are the same
function, and the kernel computes it step by step. A sequence of several
tokens from a carried state runs the same zero-state scan, and the
state's share, linear in it, is added around it with torch ops
(:func:`_from_state`). The one-token decode update stays plain PyTorch,
as JAX's ``_time_mix_sequential`` is. Norms
(``tm_norm``, ``o_norm``, ``cm_norm``) go through ``kernels.fused_rmsnorm``.

One difference in bf16 compute: JAX's token shift concatenates the f32
carried row with the bf16 sequence, which promotes the interpolated
inputs, and so the projections, to f32; the port casts the carried row
to the compute dtype and projects in it. In f32 compute the two agree.

On DTensors (the sharded step) the scan runs on each rank's heads
(:func:`rwkv_time_mix`), the channel mix is split as the MLP, the norms
take whole rows, and the decode update runs on the whole state, which
JAX's cache spec replicates over the heads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import is_dtensor, shard
from ..kernels import ops
from .layers import _param, carried_state, mm, rmsnorm

LORA = 64                 # rank of the data-dependent decay (rwkv.py:36)
LOGW_MIN = -4.0           # clamp of the per-step log-decay (rwkv.py:77)
# clamp of the decay's exponent argument: exp(2) > -LOGW_MIN, so past it
# the clamp at LOGW_MIN binds anyway and logw keeps every bit
LOGW_ARG_MAX = 2.0


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


class RWKV(nn.Module):
    """Parameters of one RWKV6 layer, time-mix and channel-mix
    (``rwkv_specs``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f32 = cfg.d_model, torch.float32
        nh, hd = rwkv_dims(cfg)
        for name in ("tm_norm", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w",
                     "w_bias", "o_norm", "cm_norm", "mu_ck"):
            setattr(self, name, _param((d,), f32, device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _param((d, d), dtype, device))
        self.wd_a = _param((d, LORA), dtype, device)
        self.wd_b = _param((LORA, d), dtype, device)
        self.u = _param((nh, hd), f32, device)
        self.w_ck = _param((d, cfg.d_ff), dtype, device)
        self.w_cv = _param((cfg.d_ff, d), dtype, device)


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; shifted[0] = prev (the carried row)."""
    return torch.cat([prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _lerp(x: torch.Tensor, shifted: torch.Tensor,
          mu: torch.Tensor) -> torch.Tensor:
    return x + (shifted - x) * mu.to(x.dtype)


def _time_mix_projections(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                          x_tm: torch.Tensor, kernels):
    """Returns h (normed x), r, k, v, logw (B, S, nh, hd) f32 and the gate
    g (compute dtype). On DTensors r, k, v and g are split as their
    weights' columns (``"qkv"``: the heads), and the decay is whole (its
    LoRA weights are replicated)."""
    B, S, _ = x.shape
    nh, hd = rwkv_dims(cfg)
    h = rmsnorm(x, p.tm_norm, cfg.norm_eps, kernels=kernels)
    shifted = _token_shift(h, x_tm)
    r = mm(_lerp(h, shifted, p.mu_r), p.w_r)
    k = mm(_lerp(h, shifted, p.mu_k), p.w_k)
    v = mm(_lerp(h, shifted, p.mu_v), p.w_v)
    g = F.silu(mm(_lerp(h, shifted, p.mu_g), p.w_g))
    xw = _lerp(h, shifted, p.mu_w)
    # the exponent's argument is clamped before exp: exp of a large one
    # overflows to inf, and the gradient through the clamp at LOGW_MIN is
    # then 0 * inf = NaN (as JAX's, rwkv.py:91-93, is there)
    logw = -torch.exp(torch.clamp(mm(mm(xw, p.wd_a), p.wd_b) + p.w_bias,
                                  max=LOGW_ARG_MAX))                 # f32
    logw = torch.clamp(logw, min=LOGW_MIN)
    heads = [t.reshape(B, S, nh, hd).float() for t in (r, k, v, logw)]
    return (h, *heads, g)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, nh, hd) -> (B, nh, S, hd), contiguous."""
    return t.transpose(1, 2).contiguous()


def _zeros_row(x: torch.Tensor) -> torch.Tensor:
    """A zero f32 row (B, d) a sequence of x (B, S, d): the carried row of
    a sequence from the zero state (a DTensor placed as x's rows)."""
    return torch.zeros_like(x[:, 0], dtype=torch.float32)


def _from_state(o, last, S0, r, lw):
    """The carried state's share of a sequence (the recurrence is linear
    in it): with c_t the inclusive running sum of ``lw`` (B, nh, S, hd)
    per key channel (<= 0), o_t (B, nh, S, hd) gains (r_t * exp(c_{t-1}))
    S0 (c_{-1} = 0) and the final state exp(c_{S-1}) S0, decayed on the
    key index as ``w_t[..., None] * S`` decays it."""
    S0 = S0.to(o.dtype)                 # the scan's dtype, as JAX's state
    c = torch.cumsum(lw, dim=2)
    before = F.pad(c[:, :, :-1], (0, 0, 1, 0))          # c_{t-1}
    o = o + torch.einsum("bntk,bnkv->bntv", r * torch.exp(before), S0)
    return o, last + torch.exp(c[:, :, -1])[..., None] * S0


def rwkv_time_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None, *, kernels=ops):
    """x (B, S, d). ``state=None``: a sequence from the zero state, any S,
    through ``kernels.rwkv6_scan``. Otherwise ``state`` holds ``S``
    (B, nh, hd, hd) and ``x_tm`` (B, d) f32: one token is a decode step,
    several the same scan with the carried state's share added
    (:func:`_from_state`). Returns (out, {"S", "x_tm"}).

    On DTensors the scan runs on each rank's heads (the decay and u cut
    to them) and its final state keeps that split, as do a carried
    state's terms; the decode update runs on the whole heads, as JAX's
    cache spec replicates the state (r, k and v gathered); the output
    norm takes its rows whole (o gathered), the gated rows are cut to
    ``w_o``'s row split and the partial sum is reduced at JAX's
    constraint (``rwkv.py:127``)."""
    B, S, d = x.shape
    nh, hd = rwkv_dims(cfg)
    x_tm = _zeros_row(x) if state is None else state["x_tm"]
    h, rh, kh, vh, lw, g = _time_mix_projections(p, x, cfg, x_tm, kernels)
    step = state is not None and S == 1
    # the scan's inputs on each rank's heads, the decode update's whole
    heads = (None if step else "heads", None)
    rh, kh, vh, lw = (shard(t, "batch", "seq", *heads)
                      for t in (rh, kh, vh, lw))
    wh = torch.exp(lw)
    if not step:
        args = [_heads_first(t) for t in (rh, kh, vh, wh)]
        rf = args[0]
        if not is_dtensor(rh):       # one flat (B * nh) dim a row a head
            args = [t.view(B * nh, S, hd) for t in args]
        o, S_final = kernels.rwkv6_scan(*args, p.u)
        o, S_final = o.view(B, nh, S, hd), S_final.view(B, nh, hd, hd)
        if state is not None:
            o, S_final = carried_state(_from_state, o, S_final, state["S"],
                                       steps=(rf, _heads_first(lw)))
        o = o.transpose(1, 2)
    else:
        r_t, k_t, v_t, w_t = rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0]
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B, nh, hd, hd)
        o = (r_t[..., None, :] @ (state["S"] + p.u[:, :, None] * kv))
        o = o.transpose(1, 2)                               # (B, 1, nh, hd)
        S_final = w_t[..., None] * state["S"] + kv
    o = rmsnorm(shard(o.reshape(B, S, d).to(x.dtype), "batch", "seq", None),
                p.o_norm, cfg.norm_eps, kernels=kernels)
    o = shard(o, "batch", "seq", "qkv") * shard(g, "batch", "seq", "qkv")
    return (shard(mm(o, p.w_o), "batch", "seq", None),
            {"S": S_final, "x_tm": h[:, -1].float()})


def rwkv_channel_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                     x_cm: torch.Tensor, *, kernels=ops):
    """Squared-ReLU FFN with token shift, split as the MLP (``rwkv.py:201``,
    ``:203``). Returns (out, {"x_cm"})."""
    h = rmsnorm(x, p.cm_norm, cfg.norm_eps, kernels=kernels)
    kx = _lerp(h, _token_shift(h, x_cm), p.mu_ck)
    hidden = shard(torch.square(F.relu(mm(kx, p.w_ck))), "batch", "seq",
                   "mlp")
    return (shard(mm(hidden, p.w_cv), "batch", "seq", None),
            {"x_cm": h[:, -1].float()})


def rwkv_block(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[dict] = None, *, kernels=ops):
    """One layer. ``state=None`` is prefill from the zero state; a state
    from :func:`rwkv_init_state` or a previous call carries on from it: a
    decode step for one token, a sequence for several. Returns (x, {"S",
    "x_tm", "x_cm"})."""
    x_cm = _zeros_row(x) if state is None else state["x_cm"]
    tm_out, tm_state = rwkv_time_mix(p, x, cfg, state, kernels=kernels)
    x = x + tm_out
    cm_out, cm_state = rwkv_channel_mix(p, x, cfg, x_cm, kernels=kernels)
    return x + cm_out, {**tm_state, **cm_state}


def rwkv_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    nh, hd = rwkv_dims(cfg)
    zeros = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros(batch, nh, hd, hd, **zeros),
            "x_tm": torch.zeros(batch, cfg.d_model, **zeros),
            "x_cm": torch.zeros(batch, cfg.d_model, **zeros)}
