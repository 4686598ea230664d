#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX
package. In order it:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the port's six CUDA kernels from src/repro_torch/csrc into
   build/repro_torch/ (timed as set-up);
3. counts the tensor-core instructions (HMMA) of the attention and
   scan kernels in the built library's SASS (cuobjdump), and fails if
   the bf16 flash_attention or bf16 ssm_scan kernel has none;
4. holds each kernel against its plain PyTorch version at the shapes the
   serving paths give it (fused_rmsnorm at d 4096, 2048 and 1536;
   bf16 attention at hd 128 and 64, and granite-moe-3b-a800m's GQA: flash
   at BH 24 over 8 KV heads, S 513 and 600, decode at BH 24 over 8, cache
   1024, hd 64; qwen2-vl-2b's GQA, G = 6: flash at BH 12 over 2, S 600,
   hd 128 in bf16 and f32, decode at BH 12 over 2, cache 1024, lengths
   1024 and 600; the scans in bf16 and f32, rwkv6_scan's f32 being its
   serving dtype), and times
   kernel, plain version, one PyTorch library call computing the same
   function where there is one, and the bound (the larger of bytes /
   3.35 TB/s and flops / the peak of their type: 989 TFLOP/s bf16 and
   495 TFLOP/s TF32 tensor cores, 67 TFLOP/s f32); then, untimed, the
   edge cases: the attention kernels' (Sq != Sk, GQA, windows across
   tile and split edges, ragged S, hd 16 and 32, lengths on split edges,
   a cache of several chunks a split) and fused_rmsnorm's (the looping
   path at d 8, 100, 8192 and 12288 and on a misaligned row, N 4096,
   x and w written by the kernel launched just before) in bf16 and in
   f32 at 2e-5, the bf16 ssm_scan tiles' at 2e-4 (chunk 16, chunk =
   S = 77, S 1, chunk 1, B/C groups, ds 16 / 32 / 128, hd 32 / 128), and
   the rwkv6_scan chunks' in bf16 and f32, the state at 2e-5 (S 1, 15,
   16, 17, 513, hd 16 / 32 / 128, one u row, w at 0, 1, 1e-30 and
   1 - 2^-24);
5. for each of deepseek-7b, zamba2-1.2b, rwkv6-1.6b,
   granite-moe-3b-a800m (32 layers of GQA attention and 40 experts, top
   8), qwen2-vl-2b (28 layers, M-RoPE, 12 query heads over 2 KV heads,
   tied head), musicgen-large (48 layers, MHA, vocab 2048) and
   moonshot-v1-16b-a3b (48 layers, a dense head layer and 47 of 64
   experts, top 6; 27.56 B parameters, the largest model one card holds)
   at full width and depth (random weights from a seed), one model on
   the card at a time, its peak device memory printed:
   a. serves 8 ragged requests through ServingEngine, whose decode steps
      are replays of one CUDA graph of LM.decode_step a slot, with the
      launch counts set to 0 just before and read just after (a replay
      adds the launches of its graph's capture), and holds the bf16
      engine's tokens against an eager greedy re-decode of every request;
   b. times one prefill and one decode step, eager and graph replay, in
      turns in one run, beside the step's weight-read floor (for
      granite, of all 40 experts, which the dispatch runs, and of the 8
      active ones);
   c. holds the graph replay against the eager LM.decode_step in f32 on
      twin caches (bitwise, or within 1e-6 of the logits' scale), for
      steps in one slot and right after a swap into another slot; the
      f32 weights are the bf16 ones cast (exact), for moonshot cut to its
      path-check depth (its f32 twin at full depth, ~110 GB, does not
      fit), after the serving model's graphs and caches are freed;
   d. holds the kernel path against the plain path on the card (prefill
      plus 4 teacher-forced decode steps), in f32 and in bf16; for
      the MoE models it also prints the route agreement of the two paths
      (token choices moved, assignments dropped on one path only, the
      smallest margin between the K-th and (K+1)-th router probability),
      since a moved choice moves the logits by a gate, not by rounding;
   e. for qwen2-vl-2b (vision) and musicgen-large (audio), the frontend
      phase: the modality frontend's embeddings of a 600-token prompt
      (input_embeds_for on the card), LM.prefill(embeds=) and 4 decode
      steps through the kernels and through the plain versions in f32,
      at the path check's depth, held within 1e-3 of the logits' scale;
6. runs the port's second path, the batched Monte-Carlo engine, whose
   kernel mc_cell (f64, one warp a cell, built with -fmad=false; step 3
   fails if its SASS holds a DFMA, or no SHFL or VOTE, the warp scans'
   instructions) runs a grid of the paper's single-node scheduler cells:
   a. holds the kernel bitwise against its plain version run on the
      host's CPU (every float, every count, n_events) on small grids: the
      MC bench's (1 minute at 60 invocations a minute, 10 functions, 4
      cores, seeds 0-1, loads 0.5 and 1.5, fifo / cfs / hybrid), a 16-core
      cell at 600 a minute for each policy, and hybrid cells with n_fifo
      1 and C - 1 and a limit below the shortest service, and the bench
      trace's arrivals in bursts on 2 cores; then at the paper grid's own
      shapes (50 cores, 16,384 task slots): the bench trace under fifo /
      cfs / hybrid (25 FIFO cores, 1633 ms) and the paper's FIFO seed-0
      cell (12,643 tasks); then at the warp's lane boundaries (31, 33 and
      65 cores, the 600-a-minute trace in 5 s bursts) and on 1057 rows of
      a cfs and a hybrid cell of 2000 tasks at once on 50 cores (8 cells
      a block, a last block of one; runqueues 40-80 long);
   b. runs the paper's grid through run_cells on the card, with the
      launch counts set to 0 just before and read just after: 50 cores,
      the default trace (12,643 tasks at seed 0) at seeds 0-3, fifo / cfs /
      hybrid (25 FIFO cores, 1633 ms); every cell's digest must equal the
      scalar engine's (repro_torch/mc/paper_digests.py), and the hybrid
      must bill less than CFS at every seed; prints each cell's summary;
   c. times the grid's launch and each policy's seed-0 cell and the
      slowest cell alone (cells/s, ns and cycles an event at the card's
      top SM clock), then a sweep: the grid 11 times over in one launch
      (132 cells), every copy's digest equal to its cell's (cells/s);
7. prints a JSON line of the kernels, then the result line.

Any failed check exits non-zero. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core peak
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 peak outside the tensor cores
TOL = 2e-2                     # bf16 kernel vs plain: |a - b| <= TOL * (1 + |b|)
F32_TOL = 2e-5                 # f32 kernel vs plain (test_kernels.py:23)
# ssm_scan: the plain version is the chunked SSD form, the f32 kernel the
# recurrence, the bf16 one the chunked form in 3xTF32; test_kernels.py:87
# holds such a pair (Pallas vs ref) at 2e-4
SSM_TOL = 2e-4
F32_PATH_TOL = 1e-3            # f32 logits: max |kernel - plain| / max |plain|
GRAPH_TOL = 1e-6               # f32 logits: max |replay - eager| / max |eager|
PATH_TOL = 2e-2                # least bf16 path tolerance (see path_check)
SEED = 0
GRANITE = "granite-moe-3b-a800m"
MOONSHOT, QWEN, MUSICGEN = ("moonshot-v1-16b-a3b", "qwen2-vl-2b",
                            "musicgen-large")
REPS, WARMUP = 15, 3           # timed calls (median) after warm-up calls


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------------

class Timer:
    """Device time of one call between two CUDA events. Before each call
    the L2 cache is flushed (a 256 MB write) and the stream is kept busy
    (torch.cuda._sleep), so the call is enqueued ahead of the device and
    the events bracket device work, not the host's launch overhead."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(nbytes: float, flops: float, flops_per_s: float
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref, tol: float = TOL) -> tuple[float, bool]:
    """Max |out - ref| over a tensor or a tuple of tensors (a scan's output
    and final state), and whether every element is within
    ``tol * (1 + |ref|)`` and finite."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    err, ok = 0.0, True
    for o, r in zip(out, ref, strict=True):
        o, r = o.float(), r.float()
        diff = (o - r).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= tol * (1.0 + r.abs())).all()) and \
            bool(o.isfinite().all())
    return err, ok


# -- phase 4: kernels against their plain versions ---------------------------

class Case(NamedTuple):
    name: str            # kernel
    label: str           # case
    kern: Callable       # kernel call
    plain: Callable      # plain version on the same inputs
    lib: Optional[Callable]  # one PyTorch call computing the same, or None
    nbytes: float        # each input read once, each output written once
    flops: float
    flops_per_s: float   # the card's peak for the operations' type
    tol: float
    timed: bool = True   # False: an edge case, checked but not timed
    serving: bool = True  # in the serving path's dtype (the JSON line's)
    model: Optional[str] = None  # a model's own shape, listed apart


def kernel_cases(kp):
    """The kernels' cases at the serving paths' shapes: deepseek-7b (hd
    128), zamba2-1.2b (attention hd 64, BH 32; ssm_scan BH 64 over one
    B/C group, hd 64, ds 64, chunk min(256, S)), rwkv6-1.6b (rwkv6_scan
    BH 32, hd 64), granite-moe-3b-a800m (d 1536; attention hd 64, 24
    query heads over 8 KV heads) and qwen2-vl-2b (attention hd 128, 12
    query heads over 2 KV heads: ``qwen_cases``), prompts up to 600
    tokens."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    BH, S = 32, 1024
    for d, rows in ((4096, (1, 32, 77, 200, 513, 600)), (2048, (1, 600)),
                    (1536, (1, 600))):
        for n in rows:
            w = randn(d, dtype=torch.float32, scale=0.1)
            x, w1 = randn(n, d), (1.0 + w).to(bf)
            yield Case("fused_rmsnorm", f"x ({n}, {d})",
                       lambda x=x, w=w: kp["fused_rmsnorm"][0](x, w),
                       lambda x=x, w=w: kp["fused_rmsnorm"][1](x, w),
                       lambda x=x, w1=w1, d=d: F.rms_norm(x, (d,), w1,
                                                          eps=1e-6),
                       2 * n * d * 2 + d * 4, 4 * n * d, BF16_FLOPS_PER_S,
                       TOL, model=GRANITE if d == 1536 else None)
    for hd, lens in ((128, (1, 77, 200, 513, 600)), (64, (77, 200, 513, 600))):
        for s in lens:
            q, k, v = randn(BH, s, hd), randn(BH, s, hd), randn(BH, s, hd)
            pairs = s * (s + 1) // 2
            yield Case(
                "flash_attention", f"BH {BH}, Sq = Sk = {s}, hd {hd}, causal",
                lambda q=q, k=k, v=v: kp["flash_attention"][0](q, k, v),
                lambda q=q, k=k, v=v: kp["flash_attention"][1](q, k, v),
                lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)[0],
                4 * BH * s * hd * 2, 4 * hd * pairs * BH, BF16_FLOPS_PER_S,
                TOL)
    bh, bh_kv, hd = 24, 8, 64                    # granite: GQA, G = 3
    for s in (513, 600):
        q, k, v = randn(bh, s, hd), randn(bh_kv, s, hd), randn(bh_kv, s, hd)
        pairs = s * (s + 1) // 2
        yield Case(
            "flash_attention",
            f"BH {bh} over {bh_kv}, Sq = Sk = {s}, hd {hd}, causal",
            lambda q=q, k=k, v=v: kp["flash_attention"][0](q, k, v),
            lambda q=q, k=k, v=v: kp["flash_attention"][1](q, k, v),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                enable_gqa=True)[0],
            2 * (bh + bh_kv) * s * hd * 2, 4 * hd * pairs * bh,
            BF16_FLOPS_PER_S, TOL, model=GRANITE)
    for hd, labels in ((128, ("1", "77", "600", "1024", "mixed 1..1024")),
                       (64, ("77", "600", "1024"))):
        for label in labels:
            lens = ([1, 77, 1024, 513] * (BH // 4) if label.startswith("mixed")
                    else [int(label)] * BH)
            q, k, v = randn(BH, 1, hd), randn(BH, S, hd), randn(BH, S, hd)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lengths[:, None])[None, :, None, :]
            yield Case(
                "decode_attention",
                f"BH {BH}, cache {S}, hd {hd}, lengths {label}",
                lambda q=q, k=k, v=v, l=lengths: kp["decode_attention"][0](
                    q, k, v, l),
                lambda q=q, k=k, v=v, l=lengths: kp["decode_attention"][1](
                    q, k, v, l),
                lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=m)[0],
                2 * sum(lens) * hd * 2 + 2 * BH * hd * 2 + 4 * BH,
                4 * hd * sum(lens), BF16_FLOPS_PER_S, TOL)
    yield from gqa_decode_cases(kp, randn, 24, 8, 64, GRANITE)   # G = 3
    chunk_cumsum = kp["ssm_scan"][2]
    bh, hd, ds = 64, 64, 64                      # zamba2: 64 heads, 1 group
    for s in (32, 200, 513, 600):
        for dt in (bf, torch.float32):
            xbar = randn(bh, s, hd, dtype=torch.float32, scale=0.5)
            B, C = randn(1, s, ds, dtype=dt), randn(1, s, ds, dtype=dt)
            chunk = min(256, s)
            cum = chunk_cumsum(-randn(bh, s, dtype=torch.float32,
                                      scale=0.2).abs(), chunk)
            # bf16 B/C: the chunked form in 3xTF32 on the tensor cores;
            # f32: the recurrence's 4 BH S hd ds flops on CUDA cores
            flops, peak = ((ssm_tc_flops(bh, 1, s, hd, ds, chunk),
                            TF32_FLOPS_PER_S) if dt == bf else
                           (4 * bh * s * hd * ds, F32_FLOPS_PER_S))
            yield Case(
                "ssm_scan", f"BH {bh}, S {s}, hd {hd}, ds {ds}, chunk {chunk}, "
                f"B/C {str(dt)[6:]}",
                lambda a=(xbar, B, C, cum), c=chunk: kp["ssm_scan"][0](
                    *a, chunk=c),
                lambda a=(xbar, B, C, cum), c=chunk: kp["ssm_scan"][1](
                    *a, chunk=c),
                None,
                4 * bh * s * hd * 2 + 2 * s * ds * B.element_size()
                + 4 * bh * s + 4 * bh * hd * ds,
                flops, peak, SSM_TOL, serving=dt == bf)
    bh, hd = 32, 64                              # rwkv6: 32 heads of 64
    chunk = kp["rwkv6_scan"][2]
    for s in (32, 200, 513, 600):
        for dt, tol in ((bf, TOL), (torch.float32, F32_TOL)):
            r, k, v = (randn(bh, s, hd, dtype=dt, scale=0.3)
                       for _ in range(3))
            w = torch.sigmoid(randn(bh, s, hd, dtype=torch.float32)).to(dt)
            u = randn(bh, hd, dtype=torch.float32, scale=0.1)
            esize = r.element_size()
            # the serving path passes f32 (models/rwkv.py casts r, k, v
            # and the decay): that case is the JSON line's
            yield Case(
                "rwkv6_scan", f"BH {bh}, S {s}, hd {hd}, {str(dt)[6:]}",
                lambda a=(r, k, v, w, u): kp["rwkv6_scan"][0](*a),
                lambda a=(r, k, v, w, u): kp["rwkv6_scan"][1](*a),
                None,
                5 * bh * s * hd * esize + 4 * bh * hd + 4 * bh * hd * hd,
                rwkv_chunk_flops(bh, s, hd, chunk), F32_FLOPS_PER_S, tol,
                serving=dt == torch.float32)
    yield from qwen_cases(kp, randn)
    yield from attention_edge_cases(kp, randn)
    yield from rmsnorm_edge_cases(kp, randn)
    yield from ssm_edge_cases(kp, randn)
    yield from rwkv_edge_cases(kp, randn)


def gqa_decode_cases(kp, randn, bh, bh_kv, hd, model):
    """decode_attention at a model's GQA shape: BH query heads over BH_kv
    cache rows, cache 1024, every row at length 600 and at 1024."""
    S = 1024
    for n in (600, 1024):
        q, k, v = randn(bh, 1, hd), randn(bh_kv, S, hd), randn(bh_kv, S, hd)
        lengths = torch.full((bh,), n, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda") < n)[None, None, None, :]
        # K and V are read once a KV head, whichever of its G query
        # heads reads them
        yield Case(
            "decode_attention", f"BH {bh} over {bh_kv}, cache {S}, hd {hd}, "
            f"lengths {n}",
            lambda q=q, k=k, v=v, l=lengths: kp["decode_attention"][0](
                q, k, v, l),
            lambda q=q, k=k, v=v, l=lengths: kp["decode_attention"][1](
                q, k, v, l),
            lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=m, enable_gqa=True)[0],
            2 * bh_kv * n * hd * 2 + 2 * bh * hd * 2 + 4 * bh,
            4 * hd * n * bh, BF16_FLOPS_PER_S, TOL, model=model)


def qwen_cases(kp, randn):
    """qwen2-vl-2b's GQA, G = 6, new to both attention kernels: flash at
    BH 12 over 2, S 600, hd 128, causal, in bf16 and f32 (the f32 checking
    path's kernel), and decode at BH 12 over 2, cache 1024."""
    bh, bh_kv, hd, s = 12, 2, 128, 600
    bf = torch.bfloat16
    pairs = s * (s + 1) // 2
    for dt, tol, peak in ((bf, TOL, BF16_FLOPS_PER_S),
                          (torch.float32, F32_TOL, F32_FLOPS_PER_S)):
        q = randn(bh, s, hd, dtype=dt)
        k, v = randn(bh_kv, s, hd, dtype=dt), randn(bh_kv, s, hd, dtype=dt)
        yield Case(
            "flash_attention",
            f"BH {bh} over {bh_kv}, Sq = Sk = {s}, hd {hd}, causal, "
            f"{str(dt)[6:]}",
            lambda q=q, k=k, v=v: kp["flash_attention"][0](q, k, v),
            lambda q=q, k=k, v=v: kp["flash_attention"][1](q, k, v),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                enable_gqa=True)[0],
            2 * (bh + bh_kv) * s * hd * q.element_size(),
            4 * hd * pairs * bh, peak, tol, model=QWEN)
    yield from gqa_decode_cases(kp, randn, bh, bh_kv, hd, QWEN)


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


def rwkv_edge_cases(kp, randn):
    """Untimed checks of the chunked rwkv6_scan kernel (chunks of 16
    steps) in bf16 (o at 2e-2) and f32 (2e-5), the final state at 2e-5
    in both: S 1, 15, 16, 17 and 513 (a last chunk of one step), hd 16,
    32 and 128 (hd 128 at S 600 in dynamic shared memory), one u row for
    every head, and w holding exact 0s and 1s, 1e-30, 1 - 2^-24 and
    1e-3."""
    rk, rp = kp["rwkv6_scan"][:2]
    picks = torch.tensor([0.0, 1.0, 1e-30, 1.0 - 2.0 ** -24, 1e-3],
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for dt, tol in ((torch.bfloat16, TOL), (torch.float32, F32_TOL)):
        tag = str(dt)[6:]
        for bh, n_u, s, hd, extreme in (
                (4, 4, 1, 64, False), (4, 4, 15, 64, False),
                (4, 4, 16, 64, False), (4, 4, 17, 64, False),
                (8, 4, 513, 64, False), (4, 4, 77, 16, False),
                (4, 2, 130, 32, False), (32, 32, 600, 128, False),
                (8, 1, 200, 64, False), (4, 2, 70, 64, True),
                (4, 4, 513, 128, True)):
            r, k, v = (randn(bh, s, hd, dtype=dt, scale=0.3)
                       for _ in range(3))
            if extreme:
                w = picks[torch.randint(0, len(picks), (bh, s, hd),
                                        generator=gen, device="cuda")]
            else:
                w = torch.sigmoid(randn(bh, s, hd, dtype=torch.float32))
            a = (r, k, v, w.to(dt), randn(n_u, hd, dtype=torch.float32,
                                          scale=0.1))
            label = (f"BH {bh}, NU {n_u}, S {s}, hd {hd}"
                     f"{', w at 0, 1, 1e-30, 1 - 2^-24' if extreme else ''}"
                     f", {tag}")
            yield Case("rwkv6_scan", label, lambda a=a: rk(*a),
                       lambda a=a: rp(*a), None, 0, 0, F32_FLOPS_PER_S, tol,
                       timed=False)
            if dt == torch.bfloat16:
                yield Case("rwkv6_scan", f"{label}, final state",
                           lambda a=a: rk(*a)[1], lambda a=a: rp(*a)[1],
                           None, 0, 0, F32_FLOPS_PER_S, F32_TOL, timed=False)


def rmsnorm_edge_cases(kp, randn):
    """Untimed checks of fused_rmsnorm's paths in bf16 (2e-2) and f32
    (2e-5): the looping path (d not a multiple of the 16-byte vector,
    d 8 and 8192 outside the register path's (1024, 4096], d 12288, a row
    off 16-byte alignment), the register path at N 4096, and x and w
    written by the kernel launched just before the norm (a programmatic
    dependent launch, which reads both only after its wait)."""
    rk, rp = kp["fused_rmsnorm"][:2]
    for dt, tol in ((torch.bfloat16, TOL), (torch.float32, F32_TOL)):
        tag = str(dt)[6:]
        for n, d in ((3, 100), (5, 8), (7, 8192), (2, 12288), (4096, 4096)):
            w = randn(d, dtype=torch.float32, scale=0.1)
            x = randn(n, d, dtype=dt)
            yield Case("fused_rmsnorm", f"x ({n}, {d}), {tag}",
                       lambda x=x, w=w: rk(x, w), lambda x=x, w=w: rp(x, w),
                       None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False)
        w = randn(4096, dtype=torch.float32, scale=0.1)
        x = randn(9 * 4096 + 1, dtype=dt)[1:].view(9, 4096)
        yield Case("fused_rmsnorm", f"x (9, 4096) off 16-byte alignment, "
                   f"{tag}", lambda x=x, w=w: rk(x, w),
                   lambda x=x, w=w: rp(x, w), None, 0, 0, BF16_FLOPS_PER_S,
                   tol, timed=False)
        for n, d in ((1, 4096), (600, 2048)):
            w = randn(d, dtype=torch.float32, scale=0.1)
            x = randn(n, d, dtype=dt)
            yield Case("fused_rmsnorm", f"x ({n}, {d}) and w written just "
                       f"before, {tag}",
                       lambda x=x, w=w: rk(x + 0.0, w * 1.0),
                       lambda x=x, w=w: rp(x, w), None, 0, 0,
                       BF16_FLOPS_PER_S, tol, timed=False)


def ssm_edge_cases(kp, randn):
    """Untimed checks of the bf16 ssm_scan kernel's tiles (64 steps that
    restart at every chunk start) at 2e-4: chunk 16, chunk = S = 77 (not
    a multiple of 64), S 1, chunk 1, BH 4 over 2 B/C groups, ds 16 / 32 /
    128, hd 32 / 128."""
    sk, sp, chunk_cumsum = kp["ssm_scan"]
    for bh, bh_bc, s, hd, ds, chunk in (
            (4, 4, 64, 64, 64, 16), (4, 1, 77, 64, 64, 77),
            (2, 2, 1, 64, 64, 1), (2, 2, 40, 64, 32, 1),
            (4, 2, 130, 64, 64, 256), (2, 1, 100, 64, 16, 256),
            (2, 1, 200, 64, 128, 128), (2, 2, 70, 32, 64, 256),
            (2, 1, 70, 128, 64, 64)):
        xbar = randn(bh, s, hd, dtype=torch.float32, scale=0.5)
        B, C = randn(bh_bc, s, ds), randn(bh_bc, s, ds)
        cum = chunk_cumsum(-randn(bh, s, dtype=torch.float32,
                                  scale=0.2).abs(), chunk)
        yield Case("ssm_scan", f"BH {bh} over {bh_bc}, S {s}, hd {hd}, ds "
                   f"{ds}, chunk {chunk}, B/C bfloat16",
                   lambda a=(xbar, B, C, cum), c=chunk: sk(*a, chunk=c),
                   lambda a=(xbar, B, C, cum), c=chunk: sp(*a, chunk=c),
                   None, 0, 0, TF32_FLOPS_PER_S, SSM_TOL, timed=False)


def attention_edge_cases(kp, randn):
    """Untimed checks of the attention kernels' tilings: bf16 at 2e-2 and
    f32 at 2e-5. flash: Sq != Sk, GQA, a window across tile edges, ragged
    S at hd 16. decode: lengths 1 and on / beside the split edges (span 64
    at cache 1024), a window across split edges, GQA, and a cache of 5000
    slots (span 128: two chunks a split)."""
    flash = (("Sq 64, Sk 192, non-causal", 4, 4, 64, 192, 64, False, 0),
             ("GQA BH 6 over 2, S 77", 6, 2, 77, 77, 128, True, 0),
             ("S 200, window 64", 4, 4, 200, 200, 32, True, 64),
             ("S 65, ragged", 4, 4, 65, 65, 16, True, 0))
    edges = [1, 63, 64, 65, 127, 128, 129, 1024]
    decode = (("lengths 1..129 on split edges", 8, 8, 1024, 128, 0, edges),
              ("window 100 across split edges", 8, 8, 1024, 64, 100,
               [150, 1024, 64, 65, 300, 1, 200, 129]),
              ("GQA BH 8 over 2", 8, 2, 1024, 128, 0,
               [1024, 65, 64, 1, 700, 129, 2, 513]),
              ("hd 32, window 64", 4, 4, 1024, 32, 64, [1, 64, 65, 1000]),
              ("hd 16, GQA BH 4 over 1", 4, 1, 1024, 16, 0, [1, 64, 65, 999]),
              ("cache 5000, span 128", 4, 4, 5000, 64, 0,
               [5000, 129, 4097, 1]))
    for dt, tol in ((torch.bfloat16, TOL), (torch.float32, F32_TOL)):
        tag = str(dt)[6:]
        fk, fp = kp["flash_attention"][:2]
        for label, bh, bh_kv, sq, sk, hd, causal, window in flash:
            q = randn(bh, sq, hd, dtype=dt)
            k, v = randn(bh_kv, sk, hd, dtype=dt), randn(bh_kv, sk, hd,
                                                         dtype=dt)
            kw = dict(causal=causal, window=window)
            yield Case("flash_attention", f"{label}, hd {hd}, {tag}",
                       lambda a=(q, k, v), kw=kw: fk(*a, **kw),
                       lambda a=(q, k, v), kw=kw: fp(*a, **kw),
                       None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False)
        dk, dp = kp["decode_attention"][:2]
        for label, bh, bh_kv, S, hd, window, lens in decode:
            q = randn(bh, 1, hd, dtype=dt)
            k, v = randn(bh_kv, S, hd, dtype=dt), randn(bh_kv, S, hd,
                                                        dtype=dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            yield Case("decode_attention", f"{label}, hd {hd}, {tag}",
                       lambda a=(q, k, v, lengths), w=window: dk(*a,
                                                                 window=w),
                       lambda a=(q, k, v, lengths), w=window: dp(*a,
                                                                 window=w),
                       None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False)


def kernel_phase(kp, timer) -> dict:
    tiny = torch.zeros(1, device="cuda")
    print(f"timer floor: a 1-element add_ takes {timer(lambda: tiny.add_(1.0)):.4f}"
          " ms in this timer (launch and L2 refill included)", flush=True)
    rows = {}
    for c in kernel_cases(kp):
        out = c.kern()
        torch.cuda.synchronize()
        err, ok = max_err(out, c.plain(), c.tol)
        if not ok:
            fail(f"{c.name} [{c.label}]: kernel disagrees with its plain "
                 f"version, max |diff| {err:.3e} (tolerance {c.tol} * (1 + "
                 f"|plain|))")
        if not c.timed:
            print(f"kernel {c.name} [{c.label}]: max_abs_err {err:.3e} "
                  f"(tolerance {c.tol})", flush=True)
            continue
        ms, plain_ms = timer(c.kern), timer(c.plain)
        lib_ms = lib_err = None
        if c.lib is not None:
            lib_err, _ = max_err(c.lib(), c.plain())
            lib_ms = timer(c.lib)
        b_ms, b_by = bound(c.nbytes, c.flops, c.flops_per_s)
        lib = ("library none" if lib_ms is None else
               f"library_ms {lib_ms:.4f} (library err {lib_err:.3e})")
        print(f"kernel {c.name} [{c.label}]: max_abs_err {err:.3e} "
              f"(tolerance {c.tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"{lib} bound_ms {b_ms:.5f} ({b_by}) bound/ms "
              f"{b_ms / ms:.3f}", flush=True)
        # the JSON line reports the serving dtype's case with the most work,
        # and a model's own shapes apart
        row = rows.setdefault(c.name, {})
        measured = dict(case=c.label, max_abs_err=err, tolerance=c.tol,
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by)
        if c.model:
            row.setdefault("model_cases", {}).setdefault(
                c.model, []).append(measured)
        elif c.serving and b_ms >= row.get("bound_ms", -1.0):
            row.update(measured)
    return rows


# -- phase 3: tensor-core instructions in the build ----------------------------

SASS_KERNELS = ("flash_tc_kernel", "flash_f32_kernel", "decode_split_kernel",
                "decode_combine_kernel", "ssm_tc_kernel", "ssm_scan_kernel",
                "rwkv6_chunk_kernel")
TENSOR_CORE_KERNELS = ("flash_tc", "ssm_tc")   # must show HMMA/HGMMA


def sass_check(lib_path: Path) -> None:
    """Count HMMA (mma.sync) and HGMMA (wgmma) instructions in the SASS of
    each attention and scan kernel (<n> is the template's head or state
    dim); the bf16 flash and ssm kernels must have some (the rwkv6 kernel
    runs on the CUDA cores and is listed for its count)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        fail("cuobjdump not found: cannot show the tensor-core path")
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            m = re.search("|".join(SASS_KERNELS), fn)
            hd = re.search(r"Li(\d+)E", fn)
            fn = (f"{m.group(0)}<{hd.group(1) if hd else ''}> "
                  f"{'bf16' if 'bfloat16' in fn else 'f32'}") if m else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    for name, n in sorted(counts.items()):
        print(f"sass: {name}: {n} HMMA/HGMMA", flush=True)
    for kernel in TENSOR_CORE_KERNELS:
        tc = [n for name, n in counts.items() if name.startswith(kernel)]
        if not tc or min(tc) == 0:
            fail(f"the bf16 {kernel}_kernel has no tensor-core instruction "
                 "in its SASS")
    mc_sass_check(res.stdout)


def mc_sass_check(sass: str) -> None:
    """The f64 and warp instructions of mc_cell_kernel: it must hold no
    DFMA (a contracted product-and-add would change the last bit;
    -fmad=false forbids them, and the kernel divides nothing), and it
    must hold SHFL and VOTE, the warp design's scans (the shuffle tree of
    the next expiry, the ballot of the first idle FIFO core)."""
    ops, fn = None, False
    for line in sass.splitlines():
        if "Function :" in line:
            fn = "mc_cell_kernel" in line
            if fn:
                ops = {}
        elif fn:
            m = re.search(r"\b(D(?:ADD|MUL|FMA|SETP|MNMX)|SHFL|VOTE|REDUX)\b",
                          line)
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    if ops is None:
        fail("mc_cell_kernel not found in the library's SASS")
    print(f"sass: mc_cell_kernel f64 and warp: {dict(sorted(ops.items()))}",
          flush=True)
    if ops.get("DFMA", 0):
        fail(f"mc_cell_kernel holds {ops['DFMA']} DFMA in its SASS")
    for op in ("SHFL", "VOTE"):
        if not ops.get(op, 0):
            fail(f"mc_cell_kernel holds no {op}: not the warp design")


# -- phase 5: the serving paths ----------------------------------------------

MODELS = ("deepseek-7b", "zamba2-1.2b", "rwkv6-1.6b", GRANITE, QWEN, MUSICGEN,
          MOONSHOT)
PROMPT_LENS = (32, 600, 77, 513, 200, 45, 333, 128)


def expected_launches(rt, cfg, n_prefill: int, n_decode: int) -> dict:
    """Kernel launches the serving path of ``cfg``'s family makes for
    ``n_prefill`` prefills and ``n_decode`` decode steps (every other
    kernel: none). Each prefill and decode step ends in the final norm."""
    L, steps = cfg.n_layers, n_prefill + n_decode
    kind = rt.family_kind(cfg)
    if kind == "zamba":           # 2 norms per SSM layer, 2 per shared block
        G, _ = rt.zamba_groups(cfg)
        return {"fused_rmsnorm": (2 * L + 2 * G + 1) * steps,
                "ssm_scan": L * n_prefill, "flash_attention": G * n_prefill,
                "decode_attention": G * n_decode}
    if kind == "rwkv":            # tm_norm, o_norm, cm_norm per layer
        return {"fused_rmsnorm": (3 * L + 1) * steps,
                "rwkv6_scan": L * n_prefill}
    return {"fused_rmsnorm": (2 * L + 1) * steps,
            "flash_attention": L * n_prefill,
            "decode_attention": L * n_decode}


def serving_phase(rt, cfg, params):
    """Serves the 8 requests; returns (launch counts, completed requests,
    the engine's LM)."""
    t0 = time.perf_counter()
    eng = rt.ServingEngine(cfg, params, n_slots=4, n_fifo=2, max_len=1024,
                           initial_limit_ms=40.0, device="cuda")
    torch.cuda.synchronize()
    if any(g is None for g in eng.decoder.graphs):
        fail(f"{cfg.name}: a slot of the engine has no captured decode step")
    print(f"engine {cfg.name}: {eng.n_slots} decode graphs captured in "
          f"{time.perf_counter() - t0:.2f} s; launches a replay "
          f"{eng.decoder.graphs[0].launches}", flush=True)
    rng = np.random.default_rng(SEED + 1)
    for rid, n in enumerate(PROMPT_LENS):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)))
        eng.submit(rt.LiveRequest(rid=rid, arrival_ms=0.0, tokens=toks,
                                  max_new=4 + 2 * rid))
    rt.ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = rt.ops.launch_counts()
    n_prefill = len(PROMPT_LENS)
    n_decode = sum(len(r.generated) - 1 for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={PROMPT_LENS[r.rid]} "
              f"tokens={len(r.generated)} exec={r.execution_ms():.1f}ms "
              f"preempt={r.preemptions} cost=${r.cost_usd():.3e}",
              flush=True)
    print(f"serving {cfg.name}: {n_prefill} prefills, {n_decode} decode "
          f"steps (graph replays) in {wall:.3f} s wall; launches {counts}",
          flush=True)
    if len(done) != n_prefill:
        fail(f"{cfg.name}: {len(done)} of {n_prefill} requests completed")
    for r in done:
        if len(r.generated) != 4 + 2 * r.rid:
            fail(f"{cfg.name} request {r.rid}: {len(r.generated)} tokens, "
                 f"expected {4 + 2 * r.rid}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            fail(f"{cfg.name} request {r.rid}: token out of range")
    if sum(r.preemptions for r in done) < 1:
        fail(f"{cfg.name}: no request was preempted")
    expect = expected_launches(rt, cfg, n_prefill, n_decode)
    for name, n in counts.items():
        if name in expect and n <= 0:
            fail(f"{cfg.name}: kernel {name} was not launched on the "
                 "serving path")
        if n != expect.get(name, 0):
            fail(f"{cfg.name}: kernel {name}: {n} launches, the path makes "
                 f"{expect.get(name, 0)}")
    return counts, done, eng.lm


def redecode_check(lm, cfg, done) -> None:
    """The engine's tokens (graph replays, slots swapped on preemption)
    against an eager greedy decode of each request on its own cache."""
    with torch.inference_mode():
        for r in done:
            logits, cache = lm.prefill(r.tokens, 1024)
            toks = [int(torch.argmax(logits[0, -1]))]
            S = r.tokens.shape[1]
            for j in range(len(r.generated) - 1):
                logits, cache = lm.decode_step(
                    torch.tensor([toks[-1]], device="cuda"), cache,
                    torch.tensor([S + j], device="cuda"))
                toks.append(int(torch.argmax(logits[0, -1])))
            if toks != r.generated:
                fail(f"{cfg.name} request {r.rid} ({r.preemptions} "
                     f"preemptions): engine tokens {r.generated}, eager "
                     f"re-decode {toks}")
    print(f"redecode {cfg.name}: the engine's tokens equal an eager greedy "
          f"decode for all {len(done)} requests "
          f"({sum(r.preemptions for r in done)} preemptions)", flush=True)


def step_times(rt, lm, cfg) -> None:
    """Host-clock time of one prefill and of one decode step, eager and as
    a graph replay, taken in turns; a step is the engine's work for one
    token (the step, then the greedy token read on the host, which
    synchronises). The device's busy and idle share within them is read by
    ``python -m repro_torch.launch.profile --arch``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (1, 513), generator=gen,
                         device="cuda")
    dec = rt.SlotDecoder(lm, 1, 1024)
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = lm.prefill(toks, 1024)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        dec.prefill(0, toks)
        tok = int(toks[0, -1])
        tok_t = toks[:, -1]
        pos_t = torch.tensor([513], device="cuda")
        walls = {"eager": [], "graph": []}
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(torch.argmax(lm.decode_step(tok_t, cache, pos_t)[0][0, -1]))
            walls["eager"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(torch.argmax(dec.step(0, tok, 513)[0, -1]))
            walls["graph"].append(time.perf_counter() - t0)
    eager_ms, graph_ms = (statistics.median(walls[k]) * 1e3
                          for k in ("eager", "graph"))
    weight_bytes = sum(p.numel() * p.element_size() for n, p in
                       lm.named_parameters()
                       if n != "embed" or cfg.tie_embeddings)
    floor = f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms"
    if cfg.n_experts:
        # the dispatch runs every expert (C = 1 slot each at S = 1), so a
        # step reads all E experts' weights; K of them do the work
        expert_bytes = sum(p.numel() * p.element_size() for n, p in
                           lm.named_parameters()
                           if ".moe.w_" in n)
        active = weight_bytes - expert_bytes * (1 - cfg.top_k / cfg.n_experts)
        floor = (f"{floor} ({weight_bytes / 1e9:.3f} GB: all "
                 f"{cfg.n_experts} experts), "
                 f"{active / HBM_BYTES_PER_S * 1e3:.3f} ms ({active / 1e9:.3f}"
                 f" GB: the {cfg.top_k} active experts)")
    print(f"step {cfg.name}: prefill 513 tokens {prefill_s * 1e3:.2f} ms "
          f"wall; decode step (cache 514) eager {eager_ms:.3f} ms, graph "
          f"replay {graph_ms:.3f} ms wall (medians of 10, in turns); "
          f"weight-read bound of a decode step {floor}", flush=True)


def graph_check(rt, cfg, params32) -> None:
    """The captured decode step against the eager LM.decode_step in f32 at
    full width (``cfg`` may be cut in depth): a 200-token prompt
    prefilled into slot 0 and into a twin
    cache, then 4 greedy steps; before the third the request is saved out
    of slot 0, slot 0 is filled with NaN, and the state is loaded into
    slot 1. Each replay must equal the eager step bitwise, or lie within
    GRAPH_TOL of the logits' scale."""
    lm = rt.LM.from_params(cfg, params32)
    dec = rt.SlotDecoder(lm, 2, 1024)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab, (1, 200), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        logits, twin = lm.prefill(prompt, 1024)
        dec.prefill(0, prompt)
        tok, slot = int(torch.argmax(logits[0, -1])), 0
        for i in range(4):
            if i == 2:
                saved = dec.save(0)
                for t in dec.caches[0].values():
                    t.fill_(float("nan"))
                dec.load(1, saved)
                del saved
                slot = 1
            got = dec.step(slot, tok, 200 + i).clone()
            want, twin = lm.decode_step(
                torch.tensor([tok], device="cuda"), twin,
                torch.tensor([200 + i], device="cuda"))
            if tuple(got.shape) != (1, 1, cfg.vocab) or \
                    not bool(got.isfinite().all()):
                fail(f"graph check {cfg.name} step {i}: replayed logits "
                     f"{tuple(got.shape)} not finite or misshaped")
            scale = float(want.abs().max())
            rel = float((got - want).abs().max()) / scale
            same = bool(torch.equal(got, want))
            print(f"graph check {cfg.name} step {i} (slot {slot}"
                  f"{', right after the swap in' if i == 2 else ''}): f32 "
                  f"replay {'bitwise equal to' if same else 'differs from'} "
                  f"the eager step, max |replay - eager| {rel:.3e} of the "
                  f"logits' scale {scale:.3f} (tolerance {GRAPH_TOL})",
                  flush=True)
            if rel > GRAPH_TOL:
                fail(f"graph check {cfg.name} step {i}: replay differs from "
                     f"the eager step by {rel:.3e} of the logits' scale")
            tok = int(torch.argmax(want[0, -1]))


# Depth of the path check where the full stack amplifies f32 rounding past
# F32_PATH_TOL. zamba2-1.2b's random weights (materialize's fan_in = G = 6
# rule makes every projection a gain of ~18) carry the scans' f32 rounding
# to the logits' scale over 38 layers; `python -m
# repro_torch.launch.path_check` measures the distance by depth (PERF.md).
# The check holds the first group (6 SSM layers and the shared block) at
# full width, where a kernel fault still shows; the serving run above
# covers all 38 layers.
# granite-moe-3b-a800m: the model rounds the expert activations to bf16
# in every compute dtype (JAX layers.py:399-401), so the paths' last-bit
# differences flip some of those roundings (2^-9), which the random
# weights then amplify: f32 |kernel - plain| is 2.3e-5 of the logits'
# scale at 1 layer, 1.4e-3 at 2 (path_check, on the bf16 draw cast to
# f32; with the activations left in f32, 4.2e-6 and 4.3e-5). At 2 layers
# one token choice moves (layer 1, a margin of 1.1e-11), but the kernel
# path on the plain path's routes keeps the same distance: rounding, not
# the route. The check holds layer 0 (GQA attention and the MoE) at full
# width; serving covers all 32 layers.
# moonshot-v1-16b-a3b: its f32 twin at full depth (~110 GB) does not fit
# beside the bf16 model (56.5 GB), so the graph and path checks take the
# dense head layer and the first 3 MoE layers (the twin ~7 GB). There the
# distance stays at 7.0e-5 from 1 to 4 layers, no choice moving
# (path_check); serving covers all 48 layers. qwen2-vl-2b (3.9e-5 at 28
# layers, 6.1e-5 with the vision frontend) and musicgen-large (6.9e-5 at
# 48, 1.0e-4 with the audio frontend) are held at full depth.
PATH_LAYERS = {"zamba2-1.2b": 6, GRANITE: 1, MOONSHOT: 4}
# models whose f32 twin is cut to the path check's depth for the graph
# check too; every other twin is the full model
TWIN_CUT = (MOONSHOT,)


def path_check(rt, cfg, params16, params32) -> None:
    """The serving path through the kernels against the same path through
    the plain versions, on the card, on the same weights.

    f32: the kernels' arithmetic alone; both paths round at 2^-24, so
    they must agree to F32_PATH_TOL of the logits' scale.
    bf16: the random weights inherit materialize's fan_in = layer-count
    rule (every projection multiplies the scale by ~12 in deepseek-7b),
    so deep stacks amplify bf16 rounding (2^-9) far beyond 2e-2. The
    bound is the noise floor measured here: the bf16 kernel path may be
    at most twice as far from the f32 result as the bf16 plain path is
    (and PATH_TOL of the scale in any case)."""
    pc = rt.path_check
    n_layers = PATH_LAYERS.get(cfg.name, cfg.n_layers)
    print(f"path check {cfg.name}: {n_layers} of {cfg.n_layers} layers at "
          "full width", flush=True)
    _, params32 = pc.depth_cut(cfg, params32, n_layers)
    cfg, params16 = pc.depth_cut(cfg, params16, n_layers)
    probe = next(n for n in params16 if n.rsplit(".", 1)[-1] in rt.MATMUL)
    w16, w32 = params16[probe], params32[probe]
    if not torch.equal(w16, w32.to(w16.dtype)):
        fail(f"path check {cfg.name}: f32 and bf16 parameters are not the "
             "same draw")
    toks = pc.prompt(cfg, "cuda")
    routes = {name: [] for name in ("k16", "p16", "k32", "p32")}
    k16 = pc.path_logits(cfg, params16, rt.ops, toks, routes["k16"])
    p16 = pc.path_logits(cfg, params16, rt.plain, toks, routes["p16"])
    k32 = pc.path_logits(cfg, params32, rt.ops, toks, routes["k32"])
    p32 = pc.path_logits(cfg, params32, rt.plain, toks, routes["p32"])
    if cfg.n_experts:
        for a, b, label in (("k32", "p32", "f32 kernel against plain"),
                            ("k16", "p16", "bf16 kernel against plain"),
                            ("p16", "p32", "bf16 plain against f32 plain")):
            agree = pc.route_agreement(routes[a], routes[b], cfg.n_experts)
            print(f"path check {cfg.name} routes, {label}: "
                  f"{pc.route_line(agree)}", flush=True)
    for i in range(len(p32)):
        for name, t in (("k16", k16[i]), ("p16", p16[i]), ("k32", k32[i])):
            if tuple(t.shape) != (1, 1, cfg.vocab) or \
                    not bool(t.isfinite().all()):
                fail(f"path check {cfg.name} step {i}: {name} logits "
                     f"{tuple(t.shape)} not finite or misshaped")
        scale = float(p32[i].abs().max())
        f32_rel = float((k32[i] - p32[i]).abs().max()) / scale
        k16_rel = float((k16[i] - p32[i]).abs().max()) / scale
        p16_rel = float((p16[i] - p32[i]).abs().max()) / scale
        kp16_rel = float((k16[i] - p16[i]).abs().max()) / scale
        bf16_tol = max(PATH_TOL, 2.0 * p16_rel)
        print(f"path check {cfg.name} step {i}: f32 |kernel - plain| "
              f"{f32_rel:.3e} (tolerance {F32_PATH_TOL}); bf16 |kernel - "
              f"f32| {k16_rel:.3e}, |plain - f32| {p16_rel:.3e}, |kernel - "
              f"plain| {kp16_rel:.3e} (tolerance {bf16_tol:.3e}); argmax "
              f"kernel/plain/f32 {int(k16[i].argmax())}/"
              f"{int(p16[i].argmax())}/{int(p32[i].argmax())} "
              f"(of max |logit| {scale:.3f})", flush=True)
        if f32_rel > F32_PATH_TOL:
            fail(f"path check {cfg.name} step {i}: f32 kernel path differs "
                 f"from the plain path by {f32_rel:.3e} of the logits' "
                 "scale")
        if k16_rel > bf16_tol:
            fail(f"path check {cfg.name} step {i}: bf16 kernel path is "
                 f"{k16_rel:.3e} from f32, beyond {bf16_tol:.3e}")


def frontend_check(rt, cfg, params32) -> None:
    """The modality frontend on the card: the embeddings of a 600-token
    prompt (``input_embeds_for``: vision, 150 patch embeddings drawn from
    a seeded generator and the rest the text embeddings rounded to bf16;
    audio, four delayed codebooks summed in f32), then LM.prefill(embeds=)
    and 4 teacher-forced decode steps through the kernels and through the
    plain versions in f32, at the path check's depth; each step within
    F32_PATH_TOL of the logits' scale."""
    pc = rt.path_check
    n_layers = PATH_LAYERS.get(cfg.name, cfg.n_layers)
    cut, params32 = pc.depth_cut(cfg, params32, n_layers)
    toks = pc.prompt(cut, "cuda", pc.FRONTEND_PROMPT)
    S = pc.FRONTEND_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    with torch.inference_mode():
        embeds = rt.input_embeds_for(cut, params32, toks[:, :S], gen)
    if tuple(embeds.shape) != (1, S, cfg.d_model) or \
            not bool(embeds.isfinite().all()):
        fail(f"frontend {cfg.name}: embeddings {tuple(embeds.shape)} not "
             "finite or misshaped")
    print(f"frontend {cfg.name} ({cfg.modality}): embeddings "
          f"{tuple(embeds.shape)} {str(embeds.dtype)[6:]} of a {S}-token "
          f"prompt; {n_layers} of {cfg.n_layers} layers in f32", flush=True)
    k32 = pc.path_logits(cut, params32, rt.ops, toks, frontend=True)
    p32 = pc.path_logits(cut, params32, rt.plain, toks, frontend=True)
    for i, (k, p) in enumerate(zip(k32, p32, strict=True)):
        if tuple(k.shape) != (1, 1, cfg.vocab) or not bool(k.isfinite().all()):
            fail(f"frontend {cfg.name} step {i}: logits {tuple(k.shape)} not "
                 "finite or misshaped")
        scale = float(p.abs().max())
        rel = float((k - p).abs().max()) / scale
        print(f"frontend {cfg.name} {'prefill' if i == 0 else f'decode {i}'}:"
              f" f32 |kernel - plain| {rel:.3e} of the logits' scale "
              f"{scale:.3f} (tolerance {F32_PATH_TOL}); argmax kernel/plain "
              f"{int(k.argmax())}/{int(p.argmax())}", flush=True)
        if rel > F32_PATH_TOL:
            fail(f"frontend {cfg.name} step {i}: f32 kernel path differs "
                 f"from the plain path by {rel:.3e} of the logits' scale")


def model_phase(rt, arch: str) -> dict:
    """Serve, time, graph-check and path-check one full-width model; its
    weights are freed before the next model's."""
    cfg = rt.configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t_model = t0 = time.perf_counter()
    params = rt.init_params(cfg, seed=SEED, device="cuda",
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
    print(f"model: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{n_params / 1e9:.3f} B parameters, {gb:.2f} GB on the card, "
          f"initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    counts, done, lm = serving_phase(rt, cfg, params)
    redecode_check(lm, cfg, done)
    step_times(rt, lm, cfg)
    serving_peak = torch.cuda.max_memory_allocated()
    del lm, done
    gc.collect()                  # the engine's graphs, pool and caches
    torch.cuda.empty_cache()
    # the f32 twin: the bf16 draw cast (exact), so no second draw
    cfg32, params32 = rt.path_check.f32_twin(
        cfg, params, PATH_LAYERS[arch] if arch in TWIN_CUT else cfg.n_layers)
    graph_check(rt, cfg32, params32)
    path_check(rt, cfg, params, params32)
    if cfg.modality != "text":
        frontend_check(rt, cfg, params32)
    del params, params32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"model {cfg.name}: peak device memory serving "
          f"{serving_peak / 1e9:.2f} GB, over the whole phase (the f32 "
          f"checks included) {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; phase {time.perf_counter() - t_model:.1f} s", flush=True)
    return counts


# -- phase 6: the batched Monte-Carlo engine ----------------------------------

MC_SMALL = dict(minutes=1, invocations_per_min=60.0, n_functions=10)
MC_16 = dict(minutes=1, invocations_per_min=600.0, n_functions=40, seed=0)
MC_POLICIES = ("fifo", "cfs", "hybrid")
MC_FLOATS = ("completion", "first_run", "cpu_time")
MC_INTS = ("preemptions", "ctx_switches", "migrations", "ok", "n_events")


def mc_arrays(rt, cells, n_slots=None):
    """run_cells' padded arrays of one (cores, slots) bucket, on the CPU;
    n_slots defaults to the bucket of the longest cell."""
    n_slots = n_slots or max(rt.mc_bucket(len(c.tasks)) for c in cells)
    return ([torch.from_numpy(a) for a in rt.mc_pack(cells, n_slots)],
            cells[0].n_cores)


def mc_compare(rt, cells, label, n_slots=None,
               n_rows=None) -> tuple[float, float, float]:
    """The kernel against the plain version (on the host's CPU) on one
    grid, bitwise, on n_rows rows that cycle through the cells (one a
    cell by default); returns (max |diff| of the floats, plain ms,
    kernel ms: the second of two launches)."""
    args, C = mc_arrays(rt, cells, n_slots)
    t0 = time.perf_counter()
    plain = rt.run_grid_plain(*args, n_cores=C)
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows = torch.arange(n_rows or len(cells)) % len(cells)
    dev = [a[rows].contiguous().cuda() for a in args]
    rt.mc_cell_cuda(*dev, n_cores=C)
    out, ms = rt.mc_time.timed(lambda: rt.mc_cell_cuda(*dev, n_cores=C))
    err = 0.0
    for k in MC_FLOATS:
        got, want = out[k].cpu(), plain[k][rows]
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            fail(f"mc_cell [{label}]: {k} differs from the plain version")
        live = ~torch.isnan(want)
        err = max(err, float((got[live] - want[live]).abs().max()))
    for k in MC_INTS:
        if not torch.equal(out[k].cpu(), plain[k][rows].to(out[k].dtype)):
            fail(f"mc_cell [{label}]: {k} differs from the plain version")
    if not bool(out["ok"].all()):
        fail(f"mc_cell [{label}]: a cell did not drain")
    print(f"kernel mc_cell [{label}]: {len(rows)} rows of {len(cells)} "
          f"cells at {C} cores, bitwise equal to the plain version "
          f"(max_abs_err {err:.1e}), n_events "
          f"{plain['n_events'].tolist()}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms on the host's CPU", flush=True)
    return err, plain_ms, ms


def mc_small_grids(rt) -> tuple[float, float, float]:
    """The small grids; returns (max error, the bench grid's plain ms and
    kernel ms)."""
    traces = [rt.generate_workload(rt.TraceSpec(**MC_SMALL, seed=s)).tasks
              for s in (0, 1)]
    bench = [rt.Cell(p, 4, rt.scale_load(t, load)) for t in traces
             for load in (0.5, 1.5) for p in MC_POLICIES]
    err, plain_ms, ms = mc_compare(rt, bench, "bench grid: seeds 0-1, loads "
                                   "0.5 / 1.5, fifo / cfs / hybrid")
    big = rt.generate_workload(rt.TraceSpec(**MC_16)).tasks
    err = max(err, mc_compare(rt, [rt.Cell(p, 16, big) for p in MC_POLICIES],
                              "16 cores, 600 a minute")[0])
    t = traces[0]
    knobs = [{"n_fifo": 1}, {"n_fifo": 3},
             {"time_limit_ms": 0.5 * min(x.service for x in t)}]
    err = max(err, mc_compare(rt, [rt.Cell("hybrid", 4, t, kw)
                                   for kw in knobs],
                              "hybrid n_fifo 1, n_fifo 3, limit below the "
                              "shortest service")[0])
    # arrivals in bursts on the 500 ms grid: same-instant events, and
    # runqueues through every slice length
    burst = [dataclasses.replace(x, arrival=500.0 * (x.arrival // 500.0))
             for x in t]
    err = max(err, mc_compare(rt, [rt.Cell(p, 2, burst) for p in MC_POLICIES],
                              "bursts on the 500 ms grid, 2 cores")[0])
    # the paper grid's shapes: its cores (the kernel's per-core layout)
    # and its slots (the runqueue heaps' offsets)
    pd = rt.paper_digests
    fifo0 = pd.paper_cells(seeds=(0,))[0]
    n_slots = rt.mc_bucket(len(fifo0.tasks))
    wide = [rt.Cell(p, fifo0.n_cores, t, pd.paper_kw(p))
            for p in MC_POLICIES] + [fifo0]
    err = max(err, mc_compare(rt, wide, "the paper grid's shapes: bench "
                              "trace fifo / cfs / hybrid and the paper's "
                              "fifo seed-0 cell", n_slots)[0])
    # the warp's lane boundaries: 31 cores (one lane idle), 33 (a second
    # round of one core), 65 (lane 0 owns three); the 600-a-minute trace
    # in bursts on a 5 s grid, so that dozens of tasks arrive at once,
    # expire together and queue
    burst16 = [dataclasses.replace(x, arrival=5000.0 * (x.arrival // 5000.0))
               for x in big]
    for C in (31, 33, 65):
        err = max(err, mc_compare(rt, [rt.Cell(p, C, burst16)
                                       for p in MC_POLICIES],
                                  f"lane boundary: {C} cores, the 600-a-"
                                  "minute trace in 5 s bursts")[0])
    # several cells a block and long runqueues: 8 * 132 + 1 rows give 8
    # cells a block (a last block of one); 2000 short tasks at once queue
    # 40 a core under cfs, and the hybrid (1 ms limit) migrates them onto
    # its CFS cores; every row must equal its cell's plain result
    crowd = [rt.Task(tid=i, arrival=0.0, service=(3.0, 6.0, 9.5, 12.0)[i % 4])
             for i in range(2000)]
    err = max(err, mc_compare(rt, [rt.Cell("cfs", 50, crowd),
                                   rt.Cell("hybrid", 50, crowd,
                                           {"time_limit_ms": 1.0})],
                              "2000 tasks at once, 8 cells a block",
                              n_rows=8 * 132 + 1)[0])
    return err, plain_ms, ms


def mc_phase(rt, smi: str) -> dict:
    """Phase 6; returns the mc_cell row of the JSON line."""
    err, plain_ms, small_ms = mc_small_grids(rt)
    pd = rt.paper_digests
    t0 = time.perf_counter()
    cells = pd.paper_cells()
    keys = [(p, s) for s in pd.SEEDS for p in pd.POLICIES]
    n_tasks = [len(c.tasks) for c in cells]
    print(f"mc paper grid: {len(cells)} cells at {cells[0].n_cores} cores, "
          f"{min(n_tasks)}-{max(n_tasks)} tasks, traces built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rt.ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.run_cells(cells)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = rt.ops.launch_counts()
    print(f"mc paper grid through run_cells: {wall:.3f} s wall (host work "
          f"included); launches {counts}", flush=True)
    buckets = {(c.n_cores, rt.mc_bucket(len(c.tasks))) for c in cells}
    if counts["mc_cell"] != len(buckets):
        fail(f"the paper grid launched mc_cell {counts['mc_cell']} times, "
             f"not once for each of its {len(buckets)} buckets")
    if any(n for name, n in counts.items() if name != "mc_cell"):
        fail(f"the paper grid launched other kernels: {counts}")
    cost = {}
    for (policy, seed), res in zip(keys, results):
        s = res.summary()
        cost[policy, seed] = s["cost_usd"]
        same = pd.cell_digest(res.tasks) == pd.DIGESTS[policy, seed]
        print(f"mc {policy:6s} seed {seed}: n {s['n']} cost_usd "
              f"{s['cost_usd']:.6f} p99_execution_s {s['p99_execution_s']:.3f}"
              f" p99_response_s {s['p99_response_s']:.3f} makespan_s "
              f"{s['makespan_s']:.3f} preemptions {s['preemptions']} "
              f"ctx_switches {s['ctx_switches']} events "
              f"{res.mc_stats['events']}; digest "
              f"{'equal to' if same else 'DIFFERS from'} the scalar "
              "engine's", flush=True)
        if not same:
            fail(f"mc {policy} seed {seed}: the digest differs from the "
                 "scalar engine's")
    for seed in pd.SEEDS:
        if not cost["hybrid", seed] < cost["cfs", seed]:
            fail(f"mc seed {seed}: hybrid bills {cost['hybrid', seed]} and "
                 f"cfs {cost['cfs', seed]}")

    # the launch alone, then each policy's seed-0 cell and the slowest
    # cell alone; cycles at the card's top SM clock
    mt = rt.mc_time
    mhz = mt.sm_clock_mhz()
    args, C = mc_arrays(rt, cells)
    dev = [a.cuda() for a in args]
    out, ms = mt.timed(lambda: rt.mc_cell_cuda(*dev, n_cores=C))
    events = out["n_events"].tolist()
    alone = {}
    for b in mt.paper_rows(events):
        alone[b] = mt.time_row(dev, C, b, events[b], mhz)
        print(f"mc timing: {keys[b][0]} seed {keys[b][1]} "
              f"{mt.describe(alone[b], mhz)}", flush=True)
    slow = max(alone, key=lambda b: events[b])
    slow_ms, slow_ns = alone[slow]["ms"], alone[slow]["ns"]
    B, N = args[0].shape
    nbytes = B * N * (2 * 8 + 3 * 8 + 3 * 4) + B * (4 + 4 + 8 + 1 + 8 + 8)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"mc timing ({smi}): grid launch {ms:.1f} ms for {B} cells, "
          f"{sum(events)} events ({B / ms * 1e3:.2f} cells/s); slowest cell "
          f"({keys[slow][0]}, seed {keys[slow][1]}, {events[slow]} events) "
          f"alone {slow_ms:.1f} ms, {slow_ns:.1f} ns and "
          f"{slow_ns * mhz / 1e3:.0f} cycles an event; bound {b_ms:.5f} ms "
          f"(bytes: {nbytes} in and out once; each cell's events are a "
          "dependent chain, so the bound is far below anything reachable)",
          flush=True)
    # the sweep: the grid mc_time.SWEEP_REPS (11) times over in one
    # launch (132 cells, one a warp); every copy must give its cell's
    # digest, so no cell depends on its neighbours
    out, sweep_ms = mt.sweep(dev, C)
    n_sweep = out["ok"].shape[0]
    bad = mt.mismatches(out, keys, n_tasks)
    print(f"mc sweep ({smi}): {n_sweep} cells in one launch, {sweep_ms:.1f} "
          f"ms, {n_sweep / sweep_ms * 1e3:.2f} cells/s; "
          f"{n_sweep - len(bad)} of {n_sweep} digests equal to the scalar "
          "engine's", flush=True)
    if bad:
        fail(f"mc sweep: rows {bad[:8]} differ from the scalar engine")
    del out
    torch.cuda.empty_cache()
    return {"case": f"paper grid: {B} cells, {C} cores, N {N}",
            "plain_case": "bench grid: 12 cells, 4 cores (plain on the "
            "host's CPU)", "launches": counts["mc_cell"],
            "max_abs_err": err, "tolerance": 0.0, "ms": ms,
            "small_ms": small_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": "bytes", "library_ms": None,
            "sweep_cells": n_sweep, "sweep_ms": sweep_ms}


# -----------------------------------------------------------------------------

SOURCES = {"fused_rmsnorm": ("src/repro_torch/csrc/fused_rmsnorm.cu",
                             "src/repro/kernels/fused_rmsnorm.py:19"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:77"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:57"),
           "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                        "src/repro/kernels/ssm_scan.py:49"),
           "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                          "src/repro/kernels/rwkv6_scan.py:46"),
           "mc_cell": ("src/repro_torch/csrc/mc_cell.cu",
                       "src/repro/mc/kernels.py:112")}


def load_port() -> SimpleNamespace:
    """The port's entry points, imported from src/ beside this script."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs, params
    from repro_torch.kernels import build, ops, plain
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_rmsnorm as rn
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.mc_cell import mc_cell_cuda, run_grid_plain
    from repro_torch.core.events import Task
    from repro_torch.launch import mc_time, path_check
    from repro_torch.mc import Cell, paper_digests, run_cells
    from repro_torch.mc.engine import _bucket, pack
    from repro_torch.traces import TraceSpec, generate_workload, scale_load
    from repro_torch.models import LM
    from repro_torch.models.frontends import input_embeds_for
    from repro_torch.models.layers import MATMUL
    from repro_torch.models.transformer import family_kind, zamba_groups
    from repro_torch.serving import LiveRequest, ServingEngine
    from repro_torch.serving.graphs import SlotDecoder
    return SimpleNamespace(
        configs=configs, init_params=params.init_params, build=build,
        ops=ops, plain=plain, LM=LM, MATMUL=MATMUL, family_kind=family_kind,
        input_embeds_for=input_embeds_for,
        path_check=path_check, mc_time=mc_time,
        zamba_groups=zamba_groups, LiveRequest=LiveRequest,
        ServingEngine=ServingEngine, SlotDecoder=SlotDecoder,
        Cell=Cell, Task=Task, run_cells=run_cells,
        paper_digests=paper_digests,
        mc_bucket=_bucket, mc_pack=pack,
        mc_cell_cuda=mc_cell_cuda, run_grid_plain=run_grid_plain,
        TraceSpec=TraceSpec, generate_workload=generate_workload,
        scale_load=scale_load,
        kernels={"fused_rmsnorm": (rn.fused_rmsnorm_cuda,
                                   rn.fused_rmsnorm_plain),
                 "flash_attention": (fa.flash_attention_cuda,
                                     fa.flash_attention_plain),
                 "decode_attention": (da.decode_attention_cuda,
                                      da.decode_attention_plain),
                 "ssm_scan": (ss.ssm_scan_cuda, ss.ssm_scan_plain,
                              ss.chunk_cumsum),
                 "rwkv6_scan": (rs.rwkv6_scan_cuda, rs.rwkv6_scan_plain,
                                rs.CHUNK)})


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    rt = load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"env: {smi} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    lib_path = rt.build.build()
    rt.build.library()
    print(f"build: {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    sass_check(lib_path)
    rows = kernel_phase(rt.kernels, Timer())

    by_model = {arch: model_phase(rt, arch) for arch in MODELS}
    t0 = time.perf_counter()
    rows["mc_cell"] = mc_phase(rt, smi)
    print(f"mc phase {time.perf_counter() - t0:.1f} s", flush=True)
    by_model["paper grid"] = {"mc_cell": rows["mc_cell"]["launches"]}
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        launches = {arch: c[name] for arch, c in by_model.items()
                    if c.get(name)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_model": launches,
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "case": r["case"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("plain_case", "small_ms", "model_cases")
               if k in r},
            **{k: r[k] for k in ("sweep_cells", "sweep_ms") if k in r}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
