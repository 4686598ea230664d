"""Transformer building blocks of the port.

Counterparts of ``repro.models.layers``: ``rmsnorm`` (:42), ``apply_rope``
(:55), ``apply_mrope`` (:66), ``_qkv`` (:99), ``attention`` (:236),
``mlp`` (:295) and ``moe`` (:366, with ``_dispatch_row`` :322 and
``_combine_row`` :351). Weights are
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

from functools import lru_cache, partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops

#: Leaf names of the matmul weights of every family: stored in the compute
#: dtype (JAX casts them on use), every other leaf stays f32.
MATMUL = frozenset((
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",       # attn, mlp, moe
    "router",                                                      # moe
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

def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotates the two halves of hd (not interleaved pairs) by f32
    ``angles`` (..., S, hd/2)."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, hd); positions broadcastable to (..., S). Rotates the
    two halves of hd (not interleaved pairs), with f32 angles."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


@lru_cache(maxsize=None)
def mrope_streams(sections: tuple, device: torch.device) -> torch.Tensor:
    """The position stream (0: t, 1: h, 2: w) of each of the hd/2
    frequency slots, ``sections[i]`` slots of stream i in order. Built
    once for each (sections, device): the decode step that reads it is
    captured in a CUDA graph, where a host-to-device copy may not run."""
    sec = torch.repeat_interleave(torch.arange(len(sections)),
                                  torch.tensor(sections))
    return sec.to(device)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections: tuple, theta: float = 1e4) -> torch.Tensor:
    """Qwen2-VL M-RoPE: x (..., S, hd); positions_3d (3, ..., S), one
    stream each of t, h and w. Frequency slot j of hd/2 turns by the
    position of its section's stream; the rotation is :func:`apply_rope`'s.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to hd/2 = "
                         f"{hd // 2}")
    freqs = _rope_freqs(hd, theta, x.device)
    pos = positions_3d.index_select(0, mrope_streams(tuple(sections),
                                                     x.device))
    return _rotate(x, pos.movedim(0, -1).to(torch.float32) * freqs)


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
    """Project + rope. positions: (B, S), or (3, B, S) M-RoPE streams
    (a (B, S) one is broadcast to the three). Returns q: (B, KV, G, S,
    hd), k/v: (B, KV, S, hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).view(B, S, H, hd).transpose(1, 2)
    k = (x @ p.wk).view(B, S, KV, hd).transpose(1, 2)
    v = (x @ p.wv).view(B, S, KV, hd).transpose(1, 2).contiguous()
    if cfg.mrope:
        pos3 = (positions if positions.dim() == 3 else
                positions[None].expand(3, *positions.shape))[:, :, None]
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
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
    """Parameters of one gated MLP sublayer (``mlp_specs``); ``d_ff``
    defaults to the config's (the dense head layers of an MoE stack take
    ``top_k * d_ff``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)
        self.norm = _param((d,), torch.float32, device)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig, *,
        kernels=ops) -> torch.Tensor:
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    act = _act(cfg)
    h = act(h @ p.w_gate) * (h @ p.w_up)
    return h @ p.w_down


def _act(cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu if cfg.act == "silu" else partial(F.gelu,
                                                    approximate="tanh")


# -- MoE (sort-based dispatch with capacity) ----------------------------------

class MoE(nn.Module):
    """Parameters of one top-k MoE sublayer (``moe_specs``). ``routes``,
    when a list, collects each call's routing (:func:`moe`) for the
    on-card path check (``launch/path_check.py``); it is None on the
    serving path."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((d, E), dtype, device)
        self.w_gate = _param((E, d, f), dtype, device)
        self.w_up = _param((E, d, f), dtype, device)
        self.w_down = _param((E, f, d), dtype, device)
        self.norm = _param((d,), torch.float32, device)
        self.routes: Optional[list] = None


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert has for one batch row of S tokens (``moe`` :391)."""
    return max(int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def route(p: MoE, h: torch.Tensor, cfg: ModelConfig):
    """Router of the normed tokens h (B, S, d): returns (probs (B, S, E)
    f32, expert ids (B, S, K), renormalised gates (B, S, K) f32).

    The top K are taken in ``jax.lax.top_k``'s order, ties to the lower
    expert index: a stable descending sort (``torch.topk`` orders ties
    arbitrarily, and bf16 router logits tie often)."""
    logits = (h @ p.router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.top_k
    return probs, top.indices[..., :K], renormalise(top.values[..., :K])


def renormalise(gates: torch.Tensor) -> torch.Tensor:
    """Gates over their sum, floored at 1e-9 (``layers.py:383``)."""
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def dispatch(h: torch.Tensor, eids: torch.Tensor, E: int, C: int):
    """``_dispatch_row`` for every batch row at once. Assignments (token,
    k) are sorted by expert with a stable sort; the c-th assignment of
    expert e goes to slot e * C + c and one ranked >= C is dropped (slot
    E * C). Returns (buf (B, E, C, d), order (B, S*K): the sort,
    flat_idx (B, S*K): the slot of each sorted assignment), JAX's
    buffer and ``(order, flat_idx)`` of its metadata.

    Every step is a fixed-shape device op (no bincount, nonzero or
    boolean indexing), so the layer runs inside a captured CUDA graph.
    The buffer is gathered, slot by slot, from the token its assignment
    holds, where JAX scatters tokens into it: the same values, and no
    index written twice."""
    B, S, D = h.shape
    K = eids.shape[-1]
    dev = h.device
    a_exp = eids.reshape(B, S * K)
    order = torch.argsort(a_exp, dim=1, stable=True)
    s_exp = a_exp.gather(1, order)
    counts = torch.zeros(B, E, dtype=torch.int64, device=dev) \
        .scatter_add_(1, a_exp, torch.ones_like(a_exp))
    starts = torch.cumsum(counts, 1) - counts
    pos_in_e = torch.arange(S * K, device=dev) - starts.gather(1, s_exp)
    flat_idx = torch.where(pos_in_e < C, s_exp * C + pos_in_e, E * C)
    # slot (e, c) <- sorted assignment starts[e] + c, if c < counts[e]
    cs = torch.arange(C, device=dev)
    src = (starts[:, :, None] + cs).clamp_max(S * K - 1).view(B, E * C)
    tok = (order // K).gather(1, src)
    filled = (cs < counts[:, :, None]).view(B, E * C, 1)
    buf = torch.where(filled, h.gather(1, tok[..., None].expand(-1, -1, D)),
                      torch.zeros((), dtype=h.dtype, device=dev))
    return buf.view(B, E, C, D), order, flat_idx


def slots_of(order: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """The slot of each assignment in (token, k) order: ``flat_idx``
    unsorted by the permutation ``order`` (B, S*K)."""
    return torch.empty_like(flat_idx).scatter_(1, order, flat_idx)


def experts(p: MoE, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The expert FFNs on the (B, E, C, d) buffer as batched products in
    the compute dtype; the activations are rounded to bf16 in every
    compute dtype (``layers.py:399-401``; in f32 the ``w_down`` product
    then runs in f32 on the rounded values)."""
    act = _act(cfg)
    hexp = act(torch.einsum("becd,edf->becf", buf, p.w_gate)) \
        * torch.einsum("becd,edf->becf", buf, p.w_up)
    hexp = hexp.to(torch.bfloat16).to(p.w_down.dtype)
    return torch.einsum("becf,efd->becd", hexp, p.w_down)


def combine(yexp: torch.Tensor, slots: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """``_combine_row`` for every batch row: each assignment's expert
    output (zero where it was dropped: a zero row past the buffer
    stands at slot E * C), scaled by its gate cast to the output dtype,
    summed over its token's K assignments. ``slots`` (B, S*K) is in
    assignment order (:func:`slots_of`), so no sum is scattered.
    Returns (B, S, d)."""
    B, E, C, D = yexp.shape
    _, S, K = gates.shape
    rows = torch.cat([yexp.reshape(B, E * C, D),
                      yexp.new_zeros(B, 1, D)], dim=1)
    out = rows.gather(1, slots[..., None].expand(-1, -1, D))
    out = out * gates.reshape(B, S * K, 1).to(out.dtype)
    return out.view(B, S, K, D).sum(2)


def load_balance_loss(probs: torch.Tensor, eids: torch.Tensor
                      ) -> torch.Tensor:
    """Switch-style aux loss (``layers.py:385-389``): E * sum over experts
    of (share of tokens whose first choice it is) * (mean probability)."""
    E = probs.shape[-1]
    first = eids[..., 0].reshape(-1)
    density = torch.zeros(E, dtype=torch.float32, device=probs.device) \
        .scatter_add_(0, first, torch.ones_like(first, dtype=torch.float32))
    density = density / first.numel()
    return E * torch.sum(density * probs.reshape(-1, E).mean(0))


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, *, kernels=ops,
        aux: bool = True):
    """Top-k MoE with per-row sort-based capacity dispatch (pre-norm,
    residual outside). Returns (y (B, S, d), the load-balance loss, or
    None with ``aux=False``: the serving path, whose jitted JAX
    counterpart drops it as dead code). With ``p.routes`` a list, appends
    this call's routing to it: expert ids (B, S, K), slots in assignment
    order (E * C: dropped), each token's K-th probability and its margin
    over the (K+1)-th."""
    E, K = cfg.n_experts, cfg.top_k
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    probs, eids, gates = route(p, h, cfg)
    C = capacity(cfg, x.shape[1])
    buf, order, flat_idx = dispatch(h, eids, E, C)
    slots = slots_of(order, flat_idx)
    y = combine(experts(p, buf, cfg), slots, gates)
    if p.routes is not None:
        top = torch.topk(probs, min(K + 1, E), dim=-1).values
        margin = (top[..., K - 1] - top[..., K] if K < E
                  else torch.full_like(top[..., 0], float("inf")))
        p.routes.append({"eids": eids, "slots": slots, "capacity": C,
                         "kth": top[..., K - 1], "margin": margin})
    return y, (load_balance_loss(probs, eids) if aux else None)
