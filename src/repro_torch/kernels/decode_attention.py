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
                           window: int = 0, softcap: float = 0.0
                           ) -> torch.Tensor:
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
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor, *,
                          window: int = 0, softcap: float = 0.0
                          ) -> torch.Tensor:
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
    out = torch.empty_like(q)
    partials = torch.empty((BH, splits, hd + 2), dtype=torch.float32,
                           device=q.device)
    # no lengths are read on the meta device: every slot counted live (a
    # full cache)
    if skip_launch(q, NAME, lambda: costs.decode(
            BH, BHkv, hd, q.dtype, BH * S, BHkv * S)):
        return out
    rc = build.library().repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        partials.data_ptr(), out.data_ptr(), BH, BHkv, S, hd, span, window,
        softcap, DTYPE_CODES[q.dtype], stream_of(q))
    build.check(rc, NAME)
    launches += 1
    return out
