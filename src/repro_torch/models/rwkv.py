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
function, and the kernel computes it step by step. The one-token decode
update stays plain PyTorch, as JAX's ``_time_mix_sequential`` is. Norms
(``tm_norm``, ``o_norm``, ``cm_norm``) go through ``kernels.fused_rmsnorm``.

One difference in bf16 compute: JAX's token shift concatenates the f32
carried row with the bf16 sequence, which promotes the interpolated
inputs, and so the projections, to f32; the port casts the carried row
to the compute dtype and projects in it. In f32 compute the two agree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import _param, mm, rmsnorm

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
    g (compute dtype)."""
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
    """(B, S, nh, hd) -> (B * nh, S, hd), contiguous."""
    B, S, nh, hd = t.shape
    return t.transpose(1, 2).reshape(B * nh, S, hd).contiguous()


def rwkv_time_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None, *, kernels=ops):
    """x (B, S, d). ``state=None``: a sequence from the zero state, any S,
    through ``kernels.rwkv6_scan``. Otherwise ``state`` holds ``S``
    (B, nh, hd, hd) and ``x_tm`` (B, d) f32 and x is one token (decode).
    Returns (out, {"S", "x_tm"})."""
    B, S, d = x.shape
    nh, hd = rwkv_dims(cfg)
    x_tm = (torch.zeros(B, d, device=x.device) if state is None
            else state["x_tm"])
    h, rh, kh, vh, lw, g = _time_mix_projections(p, x, cfg, x_tm, kernels)
    wh = torch.exp(lw)
    if state is None:
        o, S_final = kernels.rwkv6_scan(
            _heads_first(rh), _heads_first(kh), _heads_first(vh),
            _heads_first(wh), p.u)
        o = o.view(B, nh, S, hd).transpose(1, 2)
        S_final = S_final.view(B, nh, hd, hd)
    else:
        if S != 1:
            raise ValueError(f"a step from a carried state takes one "
                             f"token, got {S}")
        r_t, k_t, v_t, w_t = rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0]
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B, nh, hd, hd)
        o = (r_t[..., None, :] @ (state["S"] + p.u[:, :, None] * kv))
        o = o.transpose(1, 2)                               # (B, 1, nh, hd)
        S_final = w_t[..., None] * state["S"] + kv
    o = rmsnorm(o.reshape(B, S, d).to(x.dtype), p.o_norm, cfg.norm_eps,
                kernels=kernels) * g
    return mm(o, p.w_o), {"S": S_final, "x_tm": h[:, -1].float()}


def rwkv_channel_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                     x_cm: torch.Tensor, *, kernels=ops):
    """Squared-ReLU FFN with token shift. Returns (out, {"x_cm"})."""
    h = rmsnorm(x, p.cm_norm, cfg.norm_eps, kernels=kernels)
    kx = _lerp(h, _token_shift(h, x_cm), p.mu_ck)
    hidden = torch.square(F.relu(mm(kx, p.w_ck)))
    return mm(hidden, p.w_cv), {"x_cm": h[:, -1].float()}


def rwkv_block(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[dict] = None, *, kernels=ops):
    """One layer. ``state=None`` is prefill from the zero state; a state
    from :func:`rwkv_init_state` or a previous call makes a decode step.
    Returns (x, {"S", "x_tm", "x_cm"})."""
    x_cm = (torch.zeros(x.shape[0], cfg.d_model, device=x.device)
            if state is None else state["x_cm"])
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
