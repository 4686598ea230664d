"""Transformer building blocks of the port.

Counterparts of ``repro.models.layers``: ``rmsnorm`` (:42), ``apply_rope``
(:55), ``apply_mrope`` (:66), ``_qkv`` (:99), ``attention`` (:236),
``mlp`` (:295) and ``moe`` (:366, with ``_dispatch_row`` :322 and
``_combine_row`` :351). Weights are
kept in JAX's ``(in, out)`` orientation and applied as ``x @ w``. Matmul
weights are cast to the compute dtype (the activations' dtype) where
they are used, as JAX's ``bf16`` (:34) casts its f32 masters: serving
stores them in the compute dtype, so the cast is a no-op there; training
keeps them as f32 masters (``LM(param_dtype=torch.float32)``), so the
gradients land in f32. Norm weights stay f32.

On DTensors (the sharded step) the same code runs each rank's shards:
``shard`` stands where JAX's model places its sharding constraints, the
matmuls split as their weights' placements say, and the kernels run on
local shards (``kernels.ops``); a plain tensor is the identity's case.
The MoE layer's routing runs whole on every rank; each rank builds and
runs only its own experts' slice of the dispatch buffer and sums its
experts' outputs into a partial y, reduced at JAX's last constraint
(``dispatch_slots``, ``expert_product``, ``combine_shards``).

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

import math
from functools import lru_cache, partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import is_dtensor, named_sharding, place, shard
from ..kernels import ops

#: Leaf names of the matmul weights of every family: stored in the compute
#: dtype (JAX casts them on use), every other leaf stays f32.
MATMUL = frozenset((
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",       # attn, mlp, moe
    "router",                                                      # moe
    "w_xz", "w_B", "w_C", "w_dt", "w_out",                         # ssm
    "w_r", "w_k", "w_v", "w_g", "w_o", "wd_a", "wd_b", "w_ck", "w_cv"))  # rwkv


def _param(shape, dtype, device) -> nn.Parameter:
    """A leaf that takes no gradient until a trainer turns it on
    (``training.optimizer.make_train_step``); serving leaves it off."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's (the compute) dtype: the weight cast on use, a
    no-op where it is stored in that dtype."""
    return x @ w.to(x.dtype)


# -- norms ----------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
            kernels=ops) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back to x's
    dtype; x is (..., d)."""
    d = x.shape[-1]
    # contiguous: prefill's last positions x[:, -1:] of a batch of rows
    # are strided, and the kernel reads rows of d
    return kernels.fused_rmsnorm(x.reshape(-1, d).contiguous(), w, eps=eps) \
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

def carried_state(terms, y, last, state, steps=(), shared=()):
    """A linear recurrence from a carried state: ``terms(y, last, state,
    *steps, *shared)`` returns the zero-state scan's output ``y`` (B, nh,
    S, ...) and final state ``last`` (B, nh, ...) with the carried
    ``state``'s share added. On DTensors it runs on each rank's heads
    (``sharding.on_local``): ``state`` placed as ``last``, each of
    ``steps`` (B, nh, S[, ...]) as ``y``, each of ``shared`` (B, S, ...)
    on y's batch split and replicated elsewhere (its gradient a partial
    sum over the head split); the outputs keep y's and last's
    placements."""
    if not is_dtensor(y):
        return terms(y, last, state, *steps, *shared)
    from torch.distributed.tensor import Replicate

    from ..distributed.sharding import on_local
    rows = [p if p.is_shard(0) else Replicate() for p in y.placements]
    args = (y, last, place(state, last.placements),
            *(place(t, y.placements) for t in steps),
            *(place(t, rows) for t in shared))
    return on_local(terms, args, ((tuple(y.shape), tuple(y.placements)),
                                  (tuple(last.shape), tuple(last.placements))))


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
    hd), k/v: (B, KV, S, hd). On DTensors whose query heads are split in
    more pieces than the KV heads divide into (qwen2-vl's 12 over 2 on a
    model axis of 4: each rank's columns of ``wk`` are half a head), k
    and v are gathered whole (small: (B, KV, S, hd)) before the rope and
    q stays (B, H, S, hd) on its heads."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = mm(x, p.wq)
    k, v = mm(x, p.wk), mm(x, p.wv)
    gathered = KV % _shards(q, 2) != 0
    if gathered:
        k, v = (shard(t, "batch", "seq", None) for t in (k, v))
    q = q.view(B, S, H, hd).transpose(1, 2)
    k = k.view(B, S, KV, hd).transpose(1, 2)
    v = v.view(B, S, KV, hd).transpose(1, 2).contiguous()
    if cfg.mrope:
        pos3 = (positions if positions.dim() == 3 else
                positions[None].expand(3, *positions.shape))[:, :, None]
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions[:, None], cfg.rope_theta)
        k = apply_rope(k, positions[:, None], cfg.rope_theta)
    return (q if gathered else q.view(B, KV, H // KV, S, hd)), k, v


def _shards(t: torch.Tensor, dim: int) -> int:
    """The pieces a DTensor's ``dim`` is split in (1: whole, or a plain
    tensor)."""
    if not is_dtensor(t):
        return 1
    return math.prod(t.device_mesh.size(m) for m, p in enumerate(t.placements)
                     if p.is_shard(dim))


def seq_slots(cache: torch.Tensor) -> Optional[tuple[torch.Tensor, int]]:
    """For a DTensor cache (..., max_len, hd) split on its sequence (JAX's
    ``kv_seq``, where the KV heads do not divide the model axis): this
    rank's shard, a view to write in place, and the first slot it holds;
    None for any other cache."""
    if not is_dtensor(cache):
        return None
    at = [m for m, p in enumerate(cache.placements)
          if p.is_shard(cache.ndim - 2)]
    if not at:
        return None
    local = cache.to_local()
    return local, cache.device_mesh.get_local_rank(at[0]) * local.shape[-2]


def clear_from(cache: torch.Tensor, S: int) -> None:
    """``cache[..., S:, :] = 0`` in place, on a cache split on its
    sequence the slots from S on that this rank holds."""
    got = seq_slots(cache)
    if got is None:
        cache[..., S:, :].zero_()
        return
    local, first = got
    local[..., max(S - first, 0):, :].zero_()


def write_prompt(cache: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, :, :S] = new``: a layer's prompt keys or values (B, KV,
    S, hd) into its cache (B, KV, max_len, hd), in place. On a cache split
    on its sequence each rank writes the slots it holds at their local
    offsets, from ``new`` whole on that mesh dim (placed as the cache
    elsewhere); a prompt may end inside any rank's slice."""
    S = new.shape[2]
    got = seq_slots(cache)
    if got is None:
        cache[:, :, :S] = new
        return
    local, first = got
    n = min(S - first, local.shape[2])
    if n > 0:
        local[:, :, :n] = new.to_local()[:, :, first:first + n]


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int = 0,
              cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              update_cache: bool = False, kernels=ops):
    """Full attention sublayer (pre-norm, residual outside); scores capped
    by ``cfg.attn_logit_softcap`` when it is > 0.

    Prefill/train: ``cache=None``; ``window`` > 0 keeps keys ``k > q -
    window`` (a local layer); ``update_cache=True`` also returns this
    layer's k/v (B, KV, S, hd). Decode: x is (B, 1, d), ``cache_pos``
    (B,) the absolute position of the new token, and ``cache`` holds
    preallocated ``k``/``v``: with ``window`` 0 of (B, KV, max_len, hd),
    with ``window`` > 0 a ring of (B, KV, W, hd), W = min(window,
    max_len), where position p sits at slot p % W. Returns (out, kv or
    None).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cap = cfg.attn_logit_softcap
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    q, k, v = _qkv(p, h, cfg, positions)
    # DTensors reach the kernels unflattened: kernels.ops flattens each
    # rank's shard, where one flat (B * H) dim could not keep batch and
    # heads both split
    sharded = is_dtensor(q)
    new_cache = None
    if cache is not None and S == 1:            # decode step
        k_cache, v_cache = cache["k"], cache["v"]
        if window > 0:
            # the new key goes to slot p % W; the ring then holds
            # positions max(0, p - W + 1) .. p, the keys the mask
            # `key_positions > pos - window` of attend_cache keeps (a ring
            # of W = max_len < window never wraps: p < max_len), live in
            # its first min(p + 1, W) slots, in an order softmax ignores
            W = k_cache.shape[2]
            slot, n_live = cache_pos % W, (cache_pos + 1).clamp(max=W)
        else:
            # keys 0..pos are valid: the mask `key_positions <= pos` of
            # attend_cache, as a per-row length pos + 1
            slot, n_live = cache_pos, cache_pos + 1
        # Written IN PLACE into the caller's preallocated cache, where the
        # JAX reference is functional (dynamic_update_slice returns a new
        # cache array); slot `slot` of each row is overwritten.
        write_slot(slot, (k_cache, k[:, :, 0].to(k_cache.dtype)),
                   (v_cache, v[:, :, 0].to(v_cache.dtype)))
        # a length a query head, as q's leading dims (an expand, whose
        # size is known on the host: the step is captured in a CUDA
        # graph; `%` and `clamp` are device ops), made contiguous for
        # the kernel (a flat view of an expand of one row has stride 0)
        if q.dim() == 4:
            # _qkv gathered the KV heads: every rank takes every query
            # head over its slice of the cache's sequence (kernels.ops:
            # the ranks' partial softmax states merged)
            q = shard(q, "batch", None, None, None)
            lengths = shard(n_live.to(torch.int32)[:, None].expand(B, H),
                            "batch", None).contiguous()
        else:
            lengths = shard(n_live.to(torch.int32)[:, None, None]
                            .expand(B, KV, H // KV), "batch", "kv_heads",
                            None).contiguous()
        args = ((q, k_cache, v_cache, lengths) if sharded else
                (q.flatten(0, 2), k_cache.flatten(0, 1),   # a row a head
                 v_cache.flatten(0, 1), lengths.flatten()))
        out = kernels.decode_attention(*args, softcap=cap)
        new_cache = cache
    else:                                        # train / prefill
        args = ((q, k, v) if sharded else
                (q.flatten(0, 2), k.flatten(0, 1), v.flatten(0, 1)))
        out = kernels.flash_attention(*args, causal=True, window=window,
                                      softcap=cap)
        if update_cache:
            new_cache = {"k": k, "v": v}
    out = out.view(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
    return shard(mm(out, p.wo), "batch", "seq", None), new_cache


def write_slot(slot: torch.Tensor, *pairs) -> None:
    """``cache[b, :, slot[b]] = new[b]`` for every row b of each ``(cache,
    new)`` pair, (B, KV, S, hd) caches, in place, with one row index for
    all; on DTensors each rank writes its own rows and heads (``new`` and
    ``slot`` placed as the cache's rows and heads). On caches split on
    their sequence (:func:`seq_slots`; ``new`` and ``slot`` whole on that
    mesh dim) only the rank that holds slot p writes it, at its local
    offset; the others write back what they hold (no host sync: the
    slots are device values)."""
    first = None
    if is_dtensor(slot):
        got = seq_slots(pairs[0][0])
        first = got[1] if got else None

    def write(slot, *tensors):
        rows = torch.arange(slot.shape[0], device=slot.device)
        for cache, new in zip(tensors[::2], tensors[1::2]):
            if first is None:
                cache[rows, :, slot] = new
                continue
            at = slot - first
            own = (at >= 0) & (at < cache.shape[2])
            at = at.clamp(0, cache.shape[2] - 1)
            cache[rows, :, at] = torch.where(own[:, None, None], new,
                                             cache[rows, :, at])
    tensors = [t for pair in pairs for t in pair]
    if not is_dtensor(slot):
        return write(slot, *tensors)
    from torch.distributed.tensor.experimental import local_map
    local_map(write, out_placements=None,
              in_placements=tuple(t.placements for t in (slot, *tensors)),
              device_mesh=slot.device_mesh)(slot, *tensors)


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
    h = shard(act(mm(h, p.w_gate)) * mm(h, p.w_up), "batch", "seq", "mlp")
    return shard(mm(h, p.w_down), "batch", "seq", None)


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
    logits = mm(h, p.router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.top_k
    return probs, top.indices[..., :K], renormalise(top.values[..., :K])


def renormalise(gates: torch.Tensor) -> torch.Tensor:
    """Gates over their sum, floored at 1e-9 (``layers.py:383``)."""
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def dispatch(h: torch.Tensor, eids: torch.Tensor, E: int, C: int,
             experts: Optional[tuple[int, int]] = None):
    """``_dispatch_row`` for every batch row at once. Assignments (token,
    k) are sorted by expert with a stable sort; the c-th assignment of
    expert e goes to slot e * C + c and one ranked >= C is dropped (slot
    E * C). Returns (buf (B, E, C, d), order (B, S*K): the sort,
    flat_idx (B, S*K): the slot of each sorted assignment), JAX's
    buffer and ``(order, flat_idx)`` of its metadata. ``experts`` =
    (first, n) builds the buffer of experts first .. first + n - 1 only,
    (B, n, C, d) (a rank's experts in the sharded step); the slots keep
    their numbering over all E.

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
    if experts is not None:                  # E becomes the range's count
        first, E = experts
        starts, counts = (t[:, first:first + E] for t in (starts, counts))
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
    then runs in f32 on the rounded values). On DTensors each product
    runs on each rank's shards (:func:`expert_product`), the gate and up
    products reduced over a split d before the activation, so that the
    bf16 rounding sees whole sums, as on one device."""
    act, dt = _act(cfg), buf.dtype
    hexp = act(shard(expert_product("becd,edf->becf", buf,
                                    p.w_gate.to(dt)), *HEXP)) \
        * shard(expert_product("becd,edf->becf", buf, p.w_up.to(dt)), *HEXP)
    hexp = shard(hexp.to(torch.bfloat16).to(dt), *HEXP)
    if is_dtensor(hexp):
        # whole rows on the mesh dims that split yexp's d (BUF: moe_d
        # claims the data axis before the batch), so that the product
        # lands in yexp's layout
        from torch.distributed.tensor import Replicate
        _, want = named_sharding(buf.shape, BUF)
        hexp = place(hexp, [Replicate() if w.is_shard(3) else pl
                            for w, pl in zip(want, hexp.placements)])
    return shard(expert_product("becf,efd->becd", hexp, p.w_down.to(dt)),
                 *BUF)


def expert_product(eq: str, x: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    """``einsum(eq, x, w)`` of x (B, E, C, k) and w (E, k, n) into (B, E,
    C, n). On DTensors each rank multiplies its shards (DTensor's own
    einsum views a permuted shard it cannot view), the output placed on
    each mesh dim by its operands': the experts split on both, k split
    on both (a partial sum), the batch split on x or n on w alone."""
    if not is_dtensor(x):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..distributed.sharding import on_local
    rules = {(1, 0): Shard(1), (3, 1): Partial(), (0, None): Shard(0),
             (None, 2): Shard(3), (None, None): Replicate()}
    out = []
    for xp, wp in zip(x.placements, w.placements):
        key = (xp.dim if xp.is_shard() else None,
               wp.dim if wp.is_shard() else None)
        if key not in rules:
            raise ValueError(f"expert product {eq}: {x.placements} by "
                             f"{w.placements} splits no product")
        out.append(rules[key])
    shape = (*x.shape[:3], w.shape[2])
    (y,) = on_local(lambda a, b: torch.einsum(eq, a, b), (x, w),
                    ((shape, tuple(out)),))
    return y


def combine(yexp: torch.Tensor, slots: torch.Tensor,
            gates: torch.Tensor, first: Optional[int] = None
            ) -> torch.Tensor:
    """``_combine_row`` for every batch row: each assignment's expert
    output (zero where it was dropped: a zero row past the buffer
    stands at slot E * C), scaled by its gate cast to the output dtype,
    summed over its token's K assignments. ``slots`` (B, S*K) is in
    assignment order (:func:`slots_of`), so no sum is scattered.
    ``first``: yexp holds experts first .. first + n - 1 only (a rank's),
    and an assignment to any other expert counts as dropped, so the
    result is this rank's part of the sum. Returns (B, S, d)."""
    B, E, C, D = yexp.shape
    _, S, K = gates.shape
    if first is not None:
        slots = slots - first * C
        slots = torch.where((slots >= 0) & (slots < E * C), slots, E * C)
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

    def count(first):
        return torch.zeros(E, dtype=torch.float32, device=first.device) \
            .scatter_add_(0, first, torch.ones_like(first,
                                                    dtype=torch.float32))
    if is_dtensor(first):        # each rank counts its rows: a partial sum
        from torch.distributed.tensor import Partial, Replicate
        from ..distributed.sharding import on_local
        (density,) = on_local(count, (first,), (((E,), tuple(
            Partial() if pl.is_shard() else Replicate()
            for pl in first.placements)),))
    else:
        density = count(first)
    density = density / first.numel()
    return E * torch.sum(density * probs.reshape(-1, E).mean(0))


#: JAX's logical axes of the dispatch buffer and the expert outputs
#: (``layers.py:394``, ``:404``) and of the expert activations (``:402``)
BUF = ("batch", "experts", "moe_cap", "moe_d")
HEXP = ("batch", "experts", "moe_cap", "mlp")


def local_experts(placements: tuple, mesh, E: int) -> tuple[int, int]:
    """(this rank's first expert, its count) of a (B, E, ...) DTensor at
    ``placements`` on ``mesh``. Raises where the model axis (more than
    one device) does not split them: JAX's resolver then replicates the
    experts, and the sharded step has no replicated expert layer."""
    names = list(mesh.mesh_dim_names)
    dims = [m for m, pl in enumerate(placements) if pl.is_shard(1)]
    if "model" in names and mesh.size(names.index("model")) > 1 \
            and dims != [names.index("model")]:
        raise ValueError(
            f"{E} experts are not split over the model axis of "
            f"{mesh.size(names.index('model'))} ({placements}): JAX's "
            "resolver replicates experts that do not divide it, and the "
            "sharded step runs no replicated expert layer")
    if not dims:
        return 0, E
    n = E // mesh.size(dims[0])
    return mesh.get_local_rank(dims[0]) * n, n


def dispatch_slots(h: torch.Tensor, eids: torch.Tensor, E: int, C: int):
    """(buf (B, E, C, d), slots (B, S*K) in assignment order): the buffer
    of :func:`dispatch` and :func:`slots_of` its metadata. On DTensors
    each rank gathers only its own experts' slots, so the whole buffer is
    never made: buf is built at JAX's placements of it (BUF), from h
    placed on the same rows and d, and ``eids`` and the slots on the same
    rows (whole rows where buf's d is split on the data axis). h's
    gradient from this rank's experts is a partial sum over their
    split."""
    if not is_dtensor(h):
        buf, order, flat_idx = dispatch(h, eids, E, C)
        return buf, slots_of(order, flat_idx)
    from torch.distributed.tensor import Replicate, Shard
    from ..distributed.sharding import on_local
    mesh = h.device_mesh
    B, S, D = h.shape
    K = eids.shape[-1]
    _, at = named_sharding((B, E, C, D), BUF)
    first, n = local_experts(at, mesh, E)
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in at)
    h_at = tuple(Shard(2) if pl.is_shard(3) else r for pl, r in zip(at, rows))
    h, eids = place(h, h_at), place(eids, rows)

    def local(h, eids):
        buf, order, flat_idx = dispatch(h, eids, E, C, experts=(first, n))
        return buf, slots_of(order, flat_idx)
    return on_local(local, (h, eids), (((B, E, C, D), at),
                                       ((B, S * K), rows)))


def combine_shards(yexp: torch.Tensor, slots: torch.Tensor,
                   gates: torch.Tensor) -> torch.Tensor:
    """:func:`combine`; on DTensors each rank sums its own experts'
    outputs into its part of y (B, S, d), a partial sum over the expert
    split, d split as yexp's, which the caller's ``shard`` reduces: what
    moves is y's bytes, never the whole expert output. The slots and
    gates are placed on yexp's batch split first (whole rows where its d
    is split on the data axis: JAX's layout)."""
    if not is_dtensor(yexp):
        return combine(yexp, slots, gates)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..distributed.sharding import on_local
    mesh = yexp.device_mesh
    B, E, C, D = yexp.shape
    S = gates.shape[1]
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                 for pl in yexp.placements)
    slots, gates = place(slots, rows), place(gates, rows)
    first, _ = local_experts(yexp.placements, mesh, E)
    y_at = []
    for pl in yexp.placements:
        if pl.is_shard(2):
            raise ValueError(f"combine: the capacity dim of yexp is split "
                             f"({yexp.placements})")
        y_at.append({0: Shard(0), 1: Partial(), 3: Shard(2)}[pl.dim]
                    if pl.is_shard() else Replicate())
    (y,) = on_local(lambda ye, sl, g: combine(ye, sl, g, first),
                    (yexp, slots, gates), (((B, S, D), tuple(y_at)),))
    return y


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, *, kernels=ops,
        aux: bool = True):
    """Top-k MoE with per-row sort-based capacity dispatch (pre-norm,
    residual outside). Returns (y (B, S, d), the load-balance loss, or
    None with ``aux=False``: the serving path, whose jitted JAX
    counterpart drops it as dead code). With ``p.routes`` a list, appends
    this call's routing to it: expert ids (B, S, K), slots in assignment
    order (E * C: dropped), each token's K-th probability and its margin
    over the (K+1)-th (one device only: the path check's).

    On DTensors (the sharded step) the routing runs on every rank as on
    one device, each rank's experts on its shard of the buffer, and y is
    reduced over the expert split at JAX's last constraint."""
    E, K = cfg.n_experts, cfg.top_k
    h = rmsnorm(x, p.norm, cfg.norm_eps, kernels=kernels)
    if p.routes is not None and is_dtensor(h):
        raise ValueError("MoE routes are collected on one device (the "
                         "path check), not under a device mesh")
    probs, eids, gates = route(p, h, cfg)
    C = capacity(cfg, x.shape[1])
    eids, gates = (shard(t, "batch", "seq", None) for t in (eids, gates))
    buf, slots = dispatch_slots(h, eids, E, C)
    buf = shard(buf, *BUF)
    y = shard(combine_shards(experts(p, buf, cfg), slots, gates), "batch",
              "seq", None)
    if p.routes is not None:
        top = torch.topk(probs, min(K + 1, E), dim=-1).values
        margin = (top[..., K - 1] - top[..., K] if K < E
                  else torch.full_like(top[..., 0], float("inf")))
        p.routes.append({"eids": eids, "slots": slots, "capacity": C,
                         "kth": top[..., K - 1], "margin": margin})
    return y, (load_balance_loss(probs, eids) if aux else None)
