"""What each hand-written kernel must move and compute: the formulas its
bound is taken from, shared by ``chip_smoke.py`` (each kernel row's
``bound_ms``) and the dry run (``launch/dryrun.py``), which reads them
from the wrappers' meta route.

A cost is ``(bytes, flops, flops_per_s)``: each input read once and each
output written once, the operations this call's shapes need (an FMA is
2), and the card's peak for their type (``launch.mesh``). Where the work
depends on the data (decode's lengths) the caller gives what its data
needs; on the meta device there is no data, and the wrappers count every
cache slot live.

On a meta tensor a wrapper allocates what its CUDA call allocates,
skips the launch and records the call's cost (:func:`record`) with every
sink opened by :func:`recording`.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import numpy as np
import torch

from ..launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                           PEAK_FLOPS_TF32)

Cost = tuple[float, float, float]

# the open sinks, innermost last: the dry run's and the tests' recorders.
# Module level, as the launch counters are: a backward may run on
# autograd's own thread.
_sinks: list[list] = []


@contextmanager
def recording() -> Iterator[list]:
    """Collects ``(kernel, bytes, flops, flops_per_s)`` of each meta call
    inside the block."""
    calls: list = []
    _sinks.append(calls)
    try:
        yield calls
    finally:
        _sinks.remove(calls)


def record(name: str, cost: Cost) -> None:
    for sink in _sinks:
        sink.append((name, *cost))


def bound(nbytes: float, flops: float, flops_per_s: float
          ) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate and the flops over their peak."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_rate(dtype: torch.dtype) -> float:
    """The attention and norm kernels' rate: bf16 on the tensor cores, f32
    on the CUDA cores."""
    return PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32


def attended_pairs(seq: int, window: int) -> int:
    """(query, key) pairs of causal attention over seq positions, keys
    also within ``window`` of the query where it is > 0."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Live (query, key) pairs of one head: keys ``k <= q`` if causal and
    ``k > q - window`` with a window, absolute indices from 0."""
    if causal and sq == sk:
        return attended_pairs(sq, window)
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


# -- forward kernels ------------------------------------------------------------

def rmsnorm(n: int, d: int, dtype: torch.dtype) -> Cost:
    """x read and y written, w read; 4 flops an element."""
    return 2 * n * d * dtype.itemsize + d * 4, 4 * n * d, peak_rate(dtype)


def flash(bh: int, bh_kv: int, sq: int, sk: int, hd: int,
          dtype: torch.dtype, causal: bool = True, window: int = 0,
          lse: bool = False) -> Cost:
    """q read and o written, K and V read once a KV head (and each row's
    log-sum-exp written where autograd records the call); 4 hd flops a
    live pair and query head."""
    nbytes = (2 * bh * sq + 2 * bh_kv * sk) * hd * dtype.itemsize
    return (nbytes + (4 * bh * sq if lse else 0),
            4 * hd * flash_pairs(sq, sk, causal, window) * bh,
            peak_rate(dtype))


def decode(bh: int, bh_kv: int, hd: int, dtype: torch.dtype,
           query_keys: int, cache_keys: int, lse: bool = False) -> Cost:
    """``cache_keys`` keys and values read (over the cache rows, once a KV
    head), q read and o written, lengths read; 4 hd flops a key of each
    query head (``query_keys`` over the query rows). With ``lse`` (the
    route of a cache split on its sequence) o is written in f32 and each
    row's log-sum-exp too."""
    size = dtype.itemsize
    out = bh * hd * 4 + 4 * bh if lse else bh * hd * size
    return (2 * cache_keys * hd * size + bh * hd * size + out + 4 * bh,
            4 * hd * query_keys, peak_rate(dtype))


def ssm_tc_flops(bh: int, bh_bc: int, s: int, hd: int, ds: int,
                 chunk: int) -> int:
    """The TF32 flops of the chunked SSD form as the bf16 ssm_scan kernel
    tiles it (tiles of at most 64 steps that restart at chunk starts):
    per tile of n steps, G = C B^T on and below the diagonal once per B/C
    group (bf16, at twice the TF32 rate: counted half), and per head P X
    on and below it (3xTF32: 3 products), C H^T and the state update (2
    each, B and C being exact in TF32)."""
    total, t0 = 0, 0
    while t0 < s:
        n = min(t0 + 64, (t0 // chunk + 1) * chunk, s) - t0
        tri = n * (n + 1)               # 2 * the pairs j <= i
        total += bh_bc * tri * ds // 2 + bh * (3 * tri * hd
                                               + 8 * n * hd * ds)
        t0 += n
    return total


def ssm(bh: int, bh_bc: int, s: int, hd: int, ds: int, chunk: int,
        bc_dtype: torch.dtype) -> Cost:
    """xbar read and y written (f32), B and C read, cumlog read, h written.
    bf16 B/C: the chunked form in 3xTF32 on the tensor cores; f32: the
    recurrence's 4 BH S hd ds flops on the CUDA cores."""
    nbytes = (4 * bh * s * hd * 2 + 2 * bh_bc * s * ds * bc_dtype.itemsize
              + 4 * bh * s + 4 * bh * hd * ds)
    if bc_dtype == torch.bfloat16:
        return nbytes, ssm_tc_flops(bh, bh_bc, s, hd, ds, chunk), \
            PEAK_FLOPS_TF32
    return nbytes, 4 * bh * s * hd * ds, PEAK_FLOPS_F32


def rwkv_chunk_flops(bh: int, s: int, hd: int, chunk: int) -> int:
    """The f32 flops of the chunked form the rwkv6_scan kernel computes
    (an FMA is 2), per head and chunk of n steps, counting A once a head
    (the kernel forms it again in each block of value columns): o from
    the state, 2 n hd^2; the state update, 2 n hd^2 + hd^2 (g times S);
    A v on and below the diagonal, 2 hd n(n+1)/2; A below it, 4 hd
    n(n-1)/2 (k D, the FMA and the running product D w); A's diagonal
    r . (u k), 3 n hd; the prefix and suffix products and r a, k b,
    4 n hd."""
    total = 0
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        total += (4 * n + 1) * hd * hd + hd * n * (n + 1) \
            + 2 * hd * n * (n - 1) + 7 * n * hd
    return bh * total


def rwkv(bh: int, nu: int, s: int, hd: int, dtype: torch.dtype,
         chunk: int) -> Cost:
    """r, k, v, w read and o written, u read, the state written; the
    chunked form's f32 flops."""
    return (5 * bh * s * hd * dtype.itemsize + 4 * nu * hd
            + 4 * bh * hd * hd, rwkv_chunk_flops(bh, s, hd, chunk),
            PEAK_FLOPS_F32)


# -- backward kernels --------------------------------------------------------------

def rmsnorm_bwd(n: int, d: int, dtype: torch.dtype) -> Cost:
    """x and dy read, dx written, w read and dw written; 10 flops an
    element."""
    return (3 * n * d * dtype.itemsize + 2 * d * 4, 10 * n * d,
            peak_rate(dtype))


def flash_bwd_preprocess(bh: int, sq: int, hd: int, dtype: torch.dtype
                         ) -> Cost:
    """O and dO read, D written; 2 hd flops a row."""
    return 2 * bh * sq * hd * dtype.itemsize + bh * sq * 4, \
        2 * bh * sq * hd, peak_rate(dtype)


# the flash backward's costs hold with a logit softcap too: its tanh a
# score (and the factor 1 - tanh^2) runs on the SFU and the FMA pipe beside
# the tensor-core products, and a bound counts the products alone
def _flash_bwd_terms(bh, bh_kv, sq, sk, hd, dtype, causal, window):
    size = dtype.itemsize
    return (bh * sq * hd * size, bh_kv * sk * hd * size, 2 * bh * sq * 4,
            bh * flash_pairs(sq, sk, causal, window))


def flash_bwd_dkdv(bh: int, bh_kv: int, sq: int, sk: int, hd: int,
                   dtype: torch.dtype, causal: bool = True,
                   window: int = 0) -> Cost:
    """Q and dO read, K and V read and dK, dV written (once a KV head), the
    log-sum-exp and D read; 8 hd flops a live pair and query head."""
    qo, kv, rows, pairs = _flash_bwd_terms(bh, bh_kv, sq, sk, hd, dtype,
                                           causal, window)
    return 2 * qo + 4 * kv + rows, 8 * hd * pairs, peak_rate(dtype)


def flash_bwd_dq(bh: int, bh_kv: int, sq: int, sk: int, hd: int,
                 dtype: torch.dtype, causal: bool = True,
                 window: int = 0) -> Cost:
    """Q and dO read and dQ written, K and V read, the log-sum-exp and D
    read; 6 hd flops a live pair and query head."""
    qo, kv, rows, pairs = _flash_bwd_terms(bh, bh_kv, sq, sk, hd, dtype,
                                           causal, window)
    return 3 * qo + 2 * kv + rows, 6 * hd * pairs, peak_rate(dtype)


def ssm_bwd_flops(bh: int, bh_bc: int, s: int, hd: int, ds: int,
                  chunk: int, bf16=None) -> float:
    """The f32 flops the ssm_scan backward needs on these shapes (an FMA
    is 2): per chunk of n steps and its n(n+1)/2 live pairs, C B^T once a
    B/C group (2 ds a pair), and a head's dY X^T and P^T dY (2 hd a pair
    each) and M^T C and M B (2 ds each); per step a head's three state
    products (G B^T, X G, dY H) and the chunk's own terms of the state
    and its gradient (X^T B, dY^T C), 2 hd ds each. With ``bf16`` (B/C's
    dtype is bf16, or f32 when False), each product's flops weighted by
    the passes the kernel runs it in on the tensor cores, so that their
    time at the TF32 peak is the bound: 3 (3xTF32) where both operands
    are f32, 2 where one is B or C in bf16 (exact in TF32), and C B^T on
    bf16 at the bf16 rate (1/2)."""
    if bf16 is None:
        w3 = w2 = wcb = 1
    else:
        w3, w2, wcb = 3, (2 if bf16 else 3), (0.5 if bf16 else 3)
    total = 0
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        pairs = n * (n + 1) // 2
        total += bh_bc * pairs * 2 * ds * wcb + bh * (
            pairs * (4 * hd * w3 + 4 * ds * w2)
            + n * 2 * hd * ds * (3 * w2 + 2 * w3))
    return total


def ssm_bwd(bh: int, bh_bc: int, s: int, hd: int, ds: int, chunk: int,
            bc_dtype: torch.dtype) -> Cost:
    """xbar and dy read, dxbar written (f32), B and C read and dB, dC
    written, cumlog read and dcumlog written, dh read; the products at
    the TF32 rate over their passes (:func:`ssm_bwd_flops`)."""
    nbytes = (3 * bh * s * hd * 4 + 4 * bh_bc * s * ds * bc_dtype.itemsize
              + 2 * bh * s * 4 + bh * hd * ds * 4)
    return nbytes, ssm_bwd_flops(bh, bh_bc, s, hd, ds, chunk,
                                 bf16=bc_dtype == torch.bfloat16), \
        PEAK_FLOPS_TF32


def rwkv_bwd_flops(bh: int, s: int, hd: int) -> int:
    """The f32 flops the rwkv6_scan backward needs (an FMA is 2): per step
    and head the state forward, dr, dk, dw, dv and the carry of dS back,
    2 hd^2 each, and the bonus terms, 10 hd."""
    return bh * s * (12 * hd * hd + 10 * hd)


def rwkv_bwd(bh: int, nu: int, s: int, hd: int, dtype: torch.dtype
             ) -> Cost:
    """r, k, v, w, do read and dr, dk, dv, dw written, u read and du
    written, dS read."""
    return (9 * bh * s * hd * dtype.itemsize + 2 * nu * hd * 4
            + bh * hd * hd * 4, rwkv_bwd_flops(bh, s, hd), PEAK_FLOPS_F32)
