"""Single-query attention over a KV cache (flash-decode).

Port of the Pallas TPU kernel ``src/repro/kernels/decode_attention.py:57``.
:func:`decode_attention_plain` is the plain PyTorch version (the
semantics of ``repro.kernels.ref.decode_attention_ref``);
:func:`decode_attention_cuda` launches ``csrc/decode_attention.cu``: a
split-K pass over the cache that writes partial softmax states, then a
combine pass. :func:`plan_splits` cuts the cache into the splits.

Layout: q (BH, 1, hd), k/v (BH_kv, S, hd) caches, lengths (BH,) int32,
the count of valid cache entries of each row: row ``bh`` attends to keys
``0 .. lengths[bh] - 1`` of cache row ``bh // (BH // BH_kv)`` (and, with a
window W, only to keys ``> lengths[bh] - 1 - W``). Lengths must be >= 1;
at 0 the kernel writes zeros. A ring cache of W slots (a sliding-window
layer's) is read with lengths ``min(pos + 1, W)`` and no window. A
``softcap`` c > 0 caps each scaled score as ``flash_attention`` does.

``with_lse=True`` is the route of a cache split on its sequence (the
sharded step, ``kernels/ops.py``): the call returns the output in f32
and each row's log-sum-exp (BH,) f32 of its scaled scores, -inf where
the row has no live key (its output then zeros; a length of 0 is a
rank's slice past the live prefix). :func:`combine_splits` merges such
pairs of the slices of one cache into the whole cache's output.
"""
from __future__ import annotations

import math

import torch

from . import build, costs
from .common import (DTYPE_CODES, HEAD_DIMS, check_kernel_tensor, refuse_grad,
                     require, skip_launch, stream_of)
from .flash_attention import softcap_scores

NAME = "decode_attention"
NEG_INF = -1e30
SPLIT_CHUNK = 64     # keys a block of the split pass takes per step
MAX_SPLITS = 64      # the combine pass weighs at most this many splits
launches = 0


def plan_splits(S: int) -> tuple[int, int]:
    """(span, splits) of the split pass over a cache of ``S`` slots: each
    block takes ``span`` keys (a multiple of ``SPLIT_CHUNK``), and
    ``splits * span >= S``. It depends on S alone, so the host never
    reads ``lengths``: up to ``SPLIT_CHUNK * MAX_SPLITS`` slots a block
    takes one chunk, beyond that the span grows so that the splits stay
    at most ``MAX_SPLITS``."""
    span = SPLIT_CHUNK * max(1, -(-S // (SPLIT_CHUNK * MAX_SPLITS)))
    return span, -(-S // span)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           window: int = 0, softcap: float = 0.0,
                           with_lse: bool = False):
    BH, _, hd = q.shape
    S = k.shape[1]
    group = BH // k.shape[0]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = softcap_scores(torch.matmul(q.float(), kf.transpose(1, 2))
                       / math.sqrt(hd), softcap)
    pos = lengths.to(q.device)[:, None] - 1
    k_idx = torch.arange(S, device=q.device)[None, :]
    mask = k_idx <= pos
    if window > 0:
        mask &= k_idx > pos - window
    if with_lse:
        s = torch.where(mask[:, None, :], s, -math.inf)
        lse = torch.logsumexp(s, dim=-1)                  # (BH, 1)
        live = torch.isfinite(lse)[..., None]
        p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                        0.0)), 0.0)
        return torch.matmul(p, vf), lse[:, 0]
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def combine_splits(o: torch.Tensor, lse: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The output over a whole cache from its R slices' ``with_lse``
    pairs: ``o`` (R, ..., hd) f32 and ``lse`` (R, ...) f32, slice r's in
    row r. In slice order, M = max_r lse_r, then ``sum_r e^(lse_r - M)
    o_r / sum_r e^(lse_r - M)``, cast to ``dtype``; a slice at -inf (no
    live key) weighs 0, and a row with no live key anywhere is zeros.
    The partial-softmax collective that XLA inserts where JAX's cache is
    split on its sequence, here after an all-gather of the pairs."""
    m = lse.amax(0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    num = den = None
    for r in range(o.shape[0]):
        w = torch.exp(lse[r] - m)
        num = w[..., None] * o[r] if num is None else num + w[..., None] * o[r]
        den = w if den is None else den + w
    return (num / den.clamp_min(1e-30)[..., None]).to(dtype)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor, *,
                          window: int = 0, softcap: float = 0.0,
                          with_lse: bool = False):
    global launches
    refuse_grad(NAME, q, k, v)
    for arg, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        check_kernel_tensor(t, NAME, arg, q)
    for arg, t in (("q", q), ("k", k), ("v", v)):   # 16-byte vector loads
        require(t.data_ptr() % 16 == 0, NAME, f"{arg} must be 16-byte aligned")
    require(q.dtype in DTYPE_CODES, NAME, f"dtype {q.dtype} not supported")
    require(k.dtype == q.dtype and v.dtype == q.dtype, NAME,
            "q, k and v must share a dtype")
    require(q.dim() == 3 and q.shape[1] == 1, NAME,
            f"q must be (BH, 1, hd), got {tuple(q.shape)}")
    require(k.dim() == 3 and v.shape == k.shape, NAME,
            "k and v must be (BH_kv, S, hd) of one shape")
    BH, _, hd = q.shape
    BHkv, S, hdk = k.shape
    require(hdk == hd and hd in HEAD_DIMS, NAME,
            f"head dim must match and be one of {HEAD_DIMS}")
    require(BHkv >= 1 and BH % BHkv == 0, NAME,
            f"BH={BH} must be a multiple of BH_kv={BHkv}")
    require(S >= 1, NAME, "empty cache")
    require(lengths.dtype == torch.int32 and lengths.shape == (BH,), NAME,
            f"lengths must be int32 ({BH},)")
    require(window >= 0, NAME, "window must be >= 0")
    require(softcap >= 0, NAME, "softcap must be >= 0")
    require(BHkv <= 65535, NAME, f"BH_kv={BHkv} exceeds the grid")
    span, splits = plan_splits(S)
    if with_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((BH,), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty_like(q)
    partials = torch.empty((BH, splits, hd + 2), dtype=torch.float32,
                           device=q.device)
    result = (out, lse) if with_lse else out
    # no lengths are read on the meta device: every slot counted live (a
    # full cache)
    if skip_launch(q, NAME, lambda: costs.decode(
            BH, BHkv, hd, q.dtype, BH * S, BHkv * S, lse=with_lse)):
        return result
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            partials.data_ptr(), out.data_ptr())
    tail = (BH, BHkv, S, hd, span, window, softcap, DTYPE_CODES[q.dtype],
            stream_of(q))
    lib = build.library()
    rc = (lib.repro_decode_attention_lse(*args, lse.data_ptr(), *tail)
          if with_lse else lib.repro_decode_attention(*args, *tail))
    build.check(rc, NAME)
    launches += 1
    return result
