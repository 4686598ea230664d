"""Transformer building blocks of the port (dense parts).

Counterparts of ``repro.models.layers``: ``rmsnorm`` (:42), ``apply_rope``
(:55), ``_qkv`` (:99), ``attention`` (:236) and ``mlp`` (:295). Weights are
kept in JAX's ``(in, out)`` orientation and applied as ``x @ w``. Matmul
weights are stored in the compute dtype (JAX casts its f32 weights on
every use, which gives the same values); norm weights stay f32.

The three hot operations go through ``kernels`` (default
:mod:`repro_torch.kernels.ops`, which launches the CUDA kernels on the
card and the plain versions on the CPU): every norm through
``fused_rmsnorm``, prefill attention through ``flash_attention`` and
decode attention through ``decode_attention``. The JAX model computes
prefill attention with its own blocked XLA code; this port follows the
Pallas kernel's arithmetic instead (q scaled in f32 before Q K^T, P kept
in f32 for P V).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops

#: Leaf names of the matmul weights of every family: stored in the compute
#: dtype (JAX casts them on use), every other leaf stays f32.
MATMUL = frozenset((
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",            # attn, mlp
    "w_xz", "w_B", "w_C", "w_dt", "w_out",                         # ssm
    "w_r", "w_k", "w_v", "w_g", "w_o", "wd_a", "wd_b", "w_ck", "w_cv"))  # rwkv


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# -- norms ----------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
            kernels=ops) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back to x's
    dtype; x is (..., d)."""
    d = x.shape[-1]
    return kernels.fused_rmsnorm(x.reshape(-1, d), w, eps=eps) \
        .reshape(x.shape)


# -- rotary ------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, hd); positions broadcastable to (..., S). Rotates the
    two halves of hd (not interleaved pairs), with f32 angles."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------

class Attention(nn.Module):
    """Parameters of one attention sublayer (``attn_specs``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.wq = _param((d, H * hd), dtype, device)
        self.wk = _param((d, KV * hd), dtype, device)
        self.wv = _param((d, KV * hd), dtype, device)
        self.wo = _param((H * hd, d), dtype, device)
        self.norm = _param((d,), torch.float32, device)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """Project + rope. Returns q: (B, KV, G, S, hd), k/v: (B, KV, S, hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).view(B, S, H, hd).transpose(1, 2)
    k = (x @ p.wk).view(B, S, KV, hd).transpose(1, 2)
    v = (x @ p.wv).view(B, S, KV, hd).transpose(1, 2).contiguous()
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    return q.view(B, KV, H // KV, S, hd), k, v


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              update_cache: bool = False, kernels=ops):
    """Full attention sublayer (pre-norm, residual outside).

    Prefill/train: ``cache=None``; ``update_cache=True`` also returns this
    layer's k/v (B, KV, S, hd). Decode: x is (B, 1, d), ``cache`` holds
    preallocated ``k``/``v`` of (B, KV, max_len, hd) and ``cache_pos``
    (B,) the absolute position of the new token. Returns (out, kv or None).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    q, k, v = _qkv(p, h, cfg, positions)
    new_cache = None
    if cache is not None and S == 1:            # decode step
        k_cache, v_cache = cache["k"], cache["v"]
        # Written IN PLACE into the caller's preallocated cache, where the
        # JAX reference is functional (dynamic_update_slice returns a new
        # cache array); slot `pos` of each row is overwritten.
        rows = torch.arange(B, device=x.device)
        k_cache[rows, :, cache_pos] = k[:, :, 0].to(k_cache.dtype)
        v_cache[rows, :, cache_pos] = v[:, :, 0].to(v_cache.dtype)
        # keys 0..pos are valid: the mask `key_positions <= pos` of
        # attend_cache, as a per-row length pos + 1 (a repeat, not
        # repeat_interleave, whose output size may be read on the host:
        # the step is captured in a CUDA graph)
        lengths = (cache_pos + 1).to(torch.int32)[:, None] \
            .repeat(1, H).view(B * H)
        out = kernels.decode_attention(
            q.reshape(B * H, 1, hd), k_cache.view(B * KV, -1, hd),
            v_cache.view(B * KV, -1, hd), lengths)
        new_cache = cache
    else:                                        # train / prefill
        out = kernels.flash_attention(
            q.reshape(B * H, S, hd), k.reshape(B * KV, S, hd),
            v.reshape(B * KV, S, hd), causal=True)
        if update_cache:
            new_cache = {"k": k, "v": v}
    out = out.view(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
    return out @ p.wo, new_cache


# -- MLP -----------------------------------------------------------------------

class MLP(nn.Module):
    """Parameters of one gated MLP sublayer (``mlp_specs``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)
        self.norm = _param((d,), torch.float32, device)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig, *,
        kernels=ops) -> torch.Tensor:
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.silu if cfg.act == "silu" else partial(F.gelu, approximate="tanh")
    h = act(h @ p.w_gate) * (h @ p.w_up)
    return h @ p.w_down
