#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX
package. In order it:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the port's CUDA kernels (nine sources) from
   src/repro_torch/csrc into build/repro_torch/ (timed as set-up);
3. counts the tensor-core instructions (HMMA) of the attention and
   scan kernels in the built library's SASS (cuobjdump), and fails if
   the bf16 flash_attention kernel of any head dim of HEAD_DIMS, the
   bf16 ssm_scan kernel, the flash backward's two bf16 tensor-core
   kernels (flash_bwd_dkdv_tc, flash_bwd_dq_tc) at hd 16, 32, 64, 128,
   168 or 240, or any instance, bf16 or f32 B/C, of the ssm backward's
   two product kernels (ssm_bwd_prep, ssm_bwd_chunk: 3xTF32) have none
   (the build's ptxas lines, registers and spills of every instance,
   are printed before it);
4. holds each kernel against its plain PyTorch version at the shapes the
   serving paths give it (fused_rmsnorm at d 4096, 2048 and 1536;
   bf16 attention at hd 128 and 64, and granite-moe-3b-a800m's GQA: flash
   at BH 24 over 8 KV heads, S 513 and 600, decode at BH 24 over 8, cache
   1024, hd 64; qwen2-vl-2b's GQA, G = 6: flash at BH 12 over 2, S 600,
   hd 128 in bf16 and f32, decode at BH 12 over 2, cache 1024, lengths
   1024 and 600; gemma3-12b's (d 3840; hd 240, 16 query heads over 8 KV
   heads: flash at S 600 causal in bf16 and f32, at S 1500 with the
   window of 1024 binding, decode at cache 1024, lengths 1024 (a full
   ring of the local layers) and 600, and at cache 2048, lengths 1904, a
   global layer's; both kernels again with a logit softcap that bends the
   scores, max |s| / cap printed); gemma3-27b's (d 5376; hd 168, padded
   to 176 inside the bf16 flash kernel, 32 query heads over 16 KV heads:
   the same rows as gemma3-12b's, and the flash output written into a
   NaN-poisoned buffer, each row and the 64 elements past the last held
   against the plain version and NaN, so a store past column 167 shows);
   the scans in bf16 and f32, rwkv6_scan's
   f32 being its serving dtype), and times
   kernel, plain version, one PyTorch library call computing the same
   function where there is one, and the bound (the larger of bytes /
   3.35 TB/s and flops / the peak of their type: 989 TFLOP/s bf16 and
   495 TFLOP/s TF32 tensor cores, 67 TFLOP/s f32); then, untimed, the
   edge cases: the attention kernels' (Sq != Sk, GQA, windows across
   tile and split edges, ragged S, hd 16, 32, 168 and 240, lengths on
   split edges, a cache of several chunks a split, softcaps at hd 64, 128,
   168 and 240)
   and fused_rmsnorm's (the looping
   path at d 8, 100, 8192 and 12288 and on a misaligned row, N 4096,
   x and w written by the kernel launched just before) in bf16 and in
   f32 at 2e-5, the bf16 ssm_scan tiles' at 2e-4 (chunk 16, chunk =
   S = 77, S 1, chunk 1, B/C groups, ds 16 / 32 / 128, hd 32 / 128), and
   the rwkv6_scan chunks' in bf16 and f32, the state at 2e-5 (S 1, 15,
   16, 17, 513, hd 16 / 32 / 128, one u row, w at 0, 1, 1e-30 and
   1 - 2^-24);
4b. holds the four backward kernels against autograd through the plain
   versions, each twice for bitwise equality: fused_rmsnorm_bwd at
   (8192, 4096) and (1, 4096), flash_bwd_preprocess, flash_bwd_dkdv and
   flash_bwd_dq at BH 64 (2 x 32 heads), S 4096, hd 128, causal (the
   training shapes), in bf16 (the flash backward on the tensor cores)
   and f32 (its SIMT kernels), and at gemma3's training shapes in bf16,
   listed apart: fused_rmsnorm_bwd at (8192, 3840) and (8192, 5376), and
   the flash backward at hd 240 (BH 32 over 16 KV heads) and hd 168
   (BH 64 over 32), S 4096, causal (a global layer) and with the window
   of 1024 (a local one); all timed beside the library's backward
   (F.rms_norm's, SDPA's, with enable_gqa and the window's mask) and
   their bounds; each bf16 flash backward row's dq, dk and dv also
   within BWD_LIB_RATIO times SDPA's ||grad - plain|| / ||plain||;
   untimed, the forward
   kernels' log-sum-exp and the whole attention backward at hd 16, 32,
   64, 168 and 240, GQA G = 3, a window of 1024 at S 1500 and ragged S
   1, 63, 65, 130 (dw of the norm, a sum over N rows, at 2e-5 sqrt(N));
   then the scans' backward kernels: ssm_scan_bwd at zamba2-1.2b's
   training microbatch (BH 128 = 2 x 64 heads over 2 B/C groups, S 4096,
   hd 64, ds 64, chunk 256, B/C bf16) and rwkv6_scan_bwd at rwkv6-1.6b's
   (BH 64 = 2 x 32 heads, S 4096, hd 64, f32), each against autograd
   through the plain version (f32 gradients within 2e-5 sqrt(S) (1 +
   |plain|), bf16 dB / dC within 2e-2 (1 + |plain|)), twice for bitwise
   equality, every gradient finite, timed beside the plain backward and
   the bound (ssm_scan_bwd's products on the tensor cores, each at the
   TF32 rate over its passes: 3 where both operands are f32, 2 where B
   or C is bf16, C B^T in bf16 at 989), then untimed at the CPU design
   test's edge cases (ragged S,
   chunk 1, S 1, B/C groups, nonzero final-state gradients, a chunk whose
   log-decay spans more than 88; rwkv6's checkpoint edges, hd 16 to 128,
   one u row, w at 0 and 1, bf16); then checks that decode_attention and
   a capped flash_attention raise where a gradient is wanted, and that
   ssm_scan's and rwkv6_scan's outputs carry a grad_fn; then holds the
   dry run's meta route (src/repro_torch/launch/dryrun.py) against the
   card: each kernel and backward kernel at the training shapes of its
   backward rows (decode at deepseek-7b's serving shape), the forward
   kernels under grad, the bytes its call holds at its peak on the meta
   device (each allocation rounded to 512 bytes, as the caching
   allocator does) equal to the card call's max_memory_allocated delta;
4c. (before each of the four train cells below, the dry run reckons the
   same step, arch, depth, batch, microbatches, dtypes and remat, on the
   host's meta device: its peak plus what is live on the card as the
   cell starts must lie within DRY_RUN_TOL (5 %) of the cell's measured
   max_memory_allocated, both printed, with the predicted flops a step
   and the TFLOP/s they make at the measured wall; after it, the card's
   total_memory must equal the dry run's capacity, and what is held
   outside the caching allocator stay within the room it leaves for
   that) trains deepseek-7b at
   full width (d 4096, 32 x 128 heads, d_ff
   11008, vocab 102400) cut to 12 layers (3.267 B parameters, 52.3 GB of
   f32 masters, grads and AdamW moments; 30 layers would take 111 GB)
   for 5 steps of batch 4 x 4096 tokens in 2 microbatches through
   make_train_step, f32 masters cast to bf16 on use, per-layer remat,
   the launch counts set to 0 just before and read just after (each
   layer's attention and two norms run forward twice, the forward and
   the recomputation, and backward once); prints each step's loss, lr,
   grad norm and wall, tokens/s, model TFLOP/s and its share of 989, the
   traced last step's busy share and the backward kernels' share of the
   wall, and peak memory; fails unless the losses are finite and fall
   and every parameter has a non-zero gradient. At 2 layers: step 0's
   loss and every gradient leaf through the kernels against the plain
   path, f32 and bf16, within the noise floor measured there (the bf16
   plain path's distance from the f32 one); the gradients with remat
   bitwise equal to those without; 4 steps uninterrupted against 3
   steps, a checkpoint (CheckpointManager, JAX's layout, written on a
   thread), a fresh model and optimizer restored from it and step 3
   again, bitwise; then gemma3-12b at full width (d 3840, 16 query heads
   over 8 KV heads of hd 240, d_ff 15360, a tied head of 262,144 rows)
   cut to 6 layers (one group of 5 local layers, window 1024, and a
   global one: 2.33 B parameters, 37 GB of f32 state) for 3 steps of the
   same batches, the last traced, with the same prints and checks (its
   model FLOPs count GQA's K/V widths and the local layers' windowed
   pairs), so that the flash backward at hd 240 runs in a train step;
   then zamba2-1.2b (38 Mamba2 layers, 64 heads of 64, ds 64, chunk 256,
   the shared attention block after every 6; 1.104 B parameters, 17.7 GB
   of f32 state) and rwkv6-1.6b (24 layers; 1.483 B, 23.7 GB) at full
   width and depth, 3 steps of the same batches each, the last traced,
   with the same prints (the model FLOPs by part: matmul parameters,
   attention pairs and the scans' own flops; the scans' backward kernels'
   share of the traced step) and checks, but for the losses' fall (these
   two start at ln(vocab), where three steps on three batches move the
   loss less than the batches differ: their losses must be finite), and
   every parameter's gradient finite;
5. for each of deepseek-7b, zamba2-1.2b, rwkv6-1.6b,
   granite-moe-3b-a800m (32 layers of GQA attention and 40 experts, top
   8), qwen2-vl-2b (28 layers, M-RoPE, 12 query heads over 2 KV heads,
   tied head), musicgen-large (48 layers, MHA, vocab 2048) and
   moonshot-v1-16b-a3b (48 layers, a dense head layer and 47 of 64
   experts, top 6; 27.56 B parameters, the largest model one card holds)
   and gemma3-12b (48 layers, 8 groups of 5 local layers with a window
   of 1024 and 1 global layer; hd 240, 16 query heads over 8 KV heads, a
   tied head of 262,144 rows; served at max_len 2048 on prompts of up to
   1900 tokens, so that the window binds and the local layers' ring
   caches wrap in prefill and in decode) and gemma3-27b (62 layers: 10
   such groups and a tail of 2 local layers, d 5376, hd 168, 32 query
   heads over 16 KV heads; 28.4 B parameters, 59.4 GB, served as
   gemma3-12b) at full width and depth (random
   weights from a seed), one model on the card at a time, its peak
   device memory printed:
   a. checks that the bytes the dry run reckons for a slot's cache
      (cache_specs) equal what new_cache allocates on the card (new_cache
      allocates from cache_specs, so this holds only the allocator's
      512-byte rounding; the CPU tests hold cache_specs to JAX's), then
      serves 8 ragged requests through ServingEngine, whose decode steps
      are replays of one CUDA graph of LM.decode_step a slot, with the
      launch counts set to 0 just before and read just after (a replay
      adds the launches of its graph's capture), and holds the bf16
      engine's tokens against an eager greedy re-decode of every request;
   b. times one prefill and one decode step, eager and graph replay, in
      turns in one run, beside the step's weight-read floor (for
      granite, of all 40 experts, which the dispatch runs, and of the 8
      active ones; for gemma3 prefills of 513 and 1500 tokens and the
      decode step after the longer one), and the config's billed
      ms_per_token_decode;
   c. holds the graph replay against the eager LM.decode_step in f32 on
      twin caches (bitwise, or within 1e-6 of the logits' scale), for
      steps in one slot and right after a swap into another slot; the
      f32 weights are the bf16 ones cast (exact), for moonshot cut to its
      path-check depth (its f32 twin at full depth, ~110 GB, does not
      fit), gemma3 to its first group and a tail layer with a prompt
      of 1100 tokens (> the window), after the serving model's graphs
      and caches are freed and the bf16 weights themselves are cut to
      that depth (gemma3-27b's 59.4 GB and a twin beside them would not
      fit);
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
   f. for gemma3, the ring layout: after a 1500-token prefill and 4
      decode steps (the wrap point moves) each local layer's ring holds
      position p at slot p % 1024 for the last 1024 positions, and each
      global layer's cache every position, against the keys and values
      of the whole 1504-token sequence recomputed by one prefill, in f32
      on the path check's twin;
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
and prints no result. ``--phases`` runs a subset of sass (step 3),
kernels (4), train (4c), models (5) and mc (6) (for a partial check on
the card, or to time another checkout's kernels with this script); it
then prints no result line.
"""
from __future__ import annotations

import argparse
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
sys.path.insert(0, str(ROOT / "src"))
try:
    # the card's peaks (H100 SXM at 700 W, dense) and each kernel's bytes
    # and flops: the port's one copy, which its dry run also reads
    from repro_torch.kernels import costs
    from repro_torch.kernels.costs import bound
    from repro_torch.launch.mesh import (HBM_BW as HBM_BYTES_PER_S,
                                         HBM_BYTES, HBM_OUTSIDE_ALLOCATOR,
                                         PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S,
                                         PEAK_FLOPS_F32 as F32_FLOPS_PER_S,
                                         PEAK_FLOPS_TF32 as TF32_FLOPS_PER_S)
except ImportError as e:
    print(f"chip_smoke: FAIL: the port's package is not beside this script "
          f"({e})", file=sys.stderr, flush=True)
    sys.exit(1)
TOL = 2e-2                     # bf16 kernel vs plain: |a - b| <= TOL * (1 + |b|)
F32_TOL = 2e-5                 # f32 kernel vs plain (test_kernels.py:23)
# ssm_scan: the plain version is the chunked SSD form, the f32 kernel the
# recurrence, the bf16 one the chunked form in 3xTF32; test_kernels.py:87
# holds such a pair (Pallas vs ref) at 2e-4
SSM_TOL = 2e-4
F32_PATH_TOL = 1e-3            # f32 logits: max |kernel - plain| / max |plain|
GRAPH_TOL = 1e-6               # f32 logits: max |replay - eager| / max |eager|
PATH_TOL = 2e-2                # least bf16 path tolerance (see path_check)
# bf16 flash backward: each gradient's ||kernel - plain|| / ||plain|| at
# most this times SDPA's backward's at the same shape (both round P and
# dS to bf16), which an error confined to a few tiles cannot hide in as
# it can in TOL * (1 + |plain|)
BWD_LIB_RATIO = 2.0
SEED = 0
GRANITE = "granite-moe-3b-a800m"
MOONSHOT, QWEN, MUSICGEN = ("moonshot-v1-16b-a3b", "qwen2-vl-2b",
                            "musicgen-large")
GEMMA, GEMMA27 = "gemma3-12b", "gemma3-27b"
REPS, WARMUP = 15, 3           # timed calls (median) after warm-up calls
SLOW_PLAIN_S, SLOW_REPS = 0.5, 3   # a plain call slower than this: 3 calls


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

    def __call__(self, fn, reps: int = REPS, warmup: int = WARMUP) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
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


def norm_rel(out, ref) -> list:
    """||out - ref|| / ||ref|| (Frobenius, in f32) of a tensor or of each
    tensor of a tuple."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    return [float((o.float() - r.float()).norm() / r.float().norm())
            for o, r in zip(out, ref, strict=True)]


def max_err(out, ref, tol=TOL) -> tuple[float, bool]:
    """Max |out - ref| over a tensor or a tuple of tensors (a scan's output
    and final state, a backward's gradients), and whether every element
    is within ``tol * (1 + |ref|)`` and finite; ``tol`` is one tolerance
    or one for each tensor."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    tols = tol if isinstance(tol, tuple) else (tol,) * len(out)
    err, ok = 0.0, True
    for o, r, tol in zip(out, ref, tols, strict=True):
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
    bitwise: bool = False  # two calls must give the same bits
    # each output's ||kern - plain|| / ||plain|| at most this many times
    # the library's own (the Frobenius norm over the whole tensor)
    lib_ratio: Optional[float] = None


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
                       *costs.rmsnorm(n, d, bf), TOL,
                       model=GRANITE if d == 1536 else None)
    for hd, lens in ((128, (1, 77, 200, 513, 600)), (64, (77, 200, 513, 600))):
        for s in lens:
            q, k, v = randn(BH, s, hd), randn(BH, s, hd), randn(BH, s, hd)
            yield Case(
                "flash_attention", f"BH {BH}, Sq = Sk = {s}, hd {hd}, causal",
                lambda q=q, k=k, v=v: kp["flash_attention"][0](q, k, v),
                lambda q=q, k=k, v=v: kp["flash_attention"][1](q, k, v),
                lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)[0],
                *costs.flash(BH, BH, s, s, hd, bf), TOL)
    bh, bh_kv, hd = 24, 8, 64                    # granite: GQA, G = 3
    for s in (513, 600):
        q, k, v = randn(bh, s, hd), randn(bh_kv, s, hd), randn(bh_kv, s, hd)
        yield Case(
            "flash_attention",
            f"BH {bh} over {bh_kv}, Sq = Sk = {s}, hd {hd}, causal",
            lambda q=q, k=k, v=v: kp["flash_attention"][0](q, k, v),
            lambda q=q, k=k, v=v: kp["flash_attention"][1](q, k, v),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                enable_gqa=True)[0],
            *costs.flash(bh, bh_kv, s, s, hd, bf), TOL, model=GRANITE)
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
                *costs.decode(BH, BH, hd, bf, sum(lens), sum(lens)), TOL)
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
            yield Case(
                "ssm_scan", f"BH {bh}, S {s}, hd {hd}, ds {ds}, chunk {chunk}, "
                f"B/C {str(dt)[6:]}",
                lambda a=(xbar, B, C, cum), c=chunk: kp["ssm_scan"][0](
                    *a, chunk=c),
                lambda a=(xbar, B, C, cum), c=chunk: kp["ssm_scan"][1](
                    *a, chunk=c),
                None, *costs.ssm(bh, 1, s, hd, ds, chunk, dt), SSM_TOL,
                serving=dt == bf)
    bh, hd = 32, 64                              # rwkv6: 32 heads of 64
    chunk = kp["rwkv6_scan"][2]
    for s in (32, 200, 513, 600):
        for dt, tol in ((bf, TOL), (torch.float32, F32_TOL)):
            r, k, v = (randn(bh, s, hd, dtype=dt, scale=0.3)
                       for _ in range(3))
            w = torch.sigmoid(randn(bh, s, hd, dtype=torch.float32)).to(dt)
            u = randn(bh, hd, dtype=torch.float32, scale=0.1)
            # the serving path passes f32 (models/rwkv.py casts r, k, v
            # and the decay): that case is the JSON line's
            yield Case(
                "rwkv6_scan", f"BH {bh}, S {s}, hd {hd}, {str(dt)[6:]}",
                lambda a=(r, k, v, w, u): kp["rwkv6_scan"][0](*a),
                lambda a=(r, k, v, w, u): kp["rwkv6_scan"][1](*a),
                None, *costs.rwkv(bh, bh, s, hd, dt, chunk), tol,
                serving=dt == torch.float32)
    yield from qwen_cases(kp, randn)
    yield from attention_edge_cases(kp, randn)
    yield from rmsnorm_edge_cases(kp, randn)
    yield from ssm_edge_cases(kp, randn)
    yield from rwkv_edge_cases(kp, randn)
    # last, each model from a generator of its own: the cases above draw
    # the same inputs as before gemma3-12b's were added
    yield from gemma_cases(kp, GEMMA)
    yield from gemma_cases(kp, GEMMA27)


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
            *costs.decode(bh, bh_kv, hd, torch.bfloat16, n * bh, n * bh_kv),
            TOL, model=model)


def qwen_cases(kp, randn):
    """qwen2-vl-2b's GQA, G = 6, new to both attention kernels: flash at
    BH 12 over 2, S 600, hd 128, causal, in bf16 and f32 (the f32 checking
    path's kernel), and decode at BH 12 over 2, cache 1024."""
    bh, bh_kv, hd, s = 12, 2, 128, 600
    bf = torch.bfloat16
    for dt, tol in ((bf, TOL), (torch.float32, F32_TOL)):
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
            *costs.flash(bh, bh_kv, s, s, hd, dt), tol, model=QWEN)
    yield from gqa_decode_cases(kp, randn, bh, bh_kv, hd, QWEN)


def max_score(q, k) -> float:
    """max |q k^T| / sqrt(hd) over every (query, key) pair, GQA rows read
    as the kernels read them: the scale a softcap bends."""
    g = q.shape[0] // k.shape[0]
    s = torch.matmul(q.float(), k.float().repeat_interleave(g, 0)
                     .transpose(1, 2))
    return float(s.abs().max()) / q.shape[-1] ** 0.5


# d, BH, BH_kv and hd of a gemma3 model's kernel rows (batch 1), and the
# seed of their generator
GEMMA_SHAPES = {GEMMA: (3840, 16, 8, 240, SEED + 6),
                GEMMA27: (5376, 32, 16, 168, SEED + 7)}
EDGES = [1, 63, 64, 65, 127, 128, 129, 1024]     # decode: split edges
# untimed edge cases of each model's rows, in bf16 and f32.
# flash: (label, BH, BH_kv, Sq, Sk, hd, causal, window, cap, input scale)
# decode: (label, BH, BH_kv, cache, hd, window, cap, lengths, input scale)
GEMMA_EDGES = {
    GEMMA: ((
        ("GQA BH 4 over 2, S 130", 4, 2, 130, 130, 240, True, 0, 0.0, 1.0),
        ("Sq 64, Sk 150, non-causal", 2, 2, 64, 150, 240, False, 0, 0.0,
         1.0),
        ("S 200, window 64", 2, 1, 200, 200, 240, True, 64, 0.0, 1.0),
        ("S 1", 2, 2, 1, 1, 240, True, 0, 0.0, 1.0),
        ("softcap 1.0, S 96", 4, 4, 96, 96, 64, True, 0, 1.0, 2.0),
        ("softcap 3.0, GQA BH 6 over 2, S 77, window 16", 6, 2, 77, 77, 128,
         True, 16, 3.0, 2.0),
        ("softcap 2.0, GQA BH 4 over 2, S 130, window 48", 4, 2, 130, 130,
         240, True, 48, 2.0, 2.0)), (
        ("GQA BH 8 over 4, lengths on split edges", 8, 4, 1024, 240, 0, 0.0,
         EDGES, 1.0),
        ("window 100 across split edges", 4, 4, 1024, 240, 100, 0.0,
         [150, 1024, 64, 1], 1.0),
        ("softcap 1.0", 4, 4, 512, 64, 0, 1.0, [512, 100, 7, 1], 2.0),
        ("softcap 1.5, GQA BH 8 over 4", 8, 4, 1024, 240, 0, 1.5,
         [1024, 1024, 700, 3, 1, 64, 65, 1000], 2.0))),
    # hd 168: ragged S across the 64-row tiles, Sq != Sk both ways, a
    # window across tile edges, a cap the template takes though the
    # config's is 0
    GEMMA27: ((
        ("GQA BH 4 over 2, S 1", 4, 2, 1, 1, 168, True, 0, 0.0, 1.0),
        ("GQA BH 4 over 2, S 63", 4, 2, 63, 63, 168, True, 0, 0.0, 1.0),
        ("GQA BH 4 over 2, S 65", 4, 2, 65, 65, 168, True, 0, 0.0, 1.0),
        ("GQA BH 4 over 2, S 130", 4, 2, 130, 130, 168, True, 0, 0.0, 1.0),
        ("Sq 64, Sk 150, non-causal", 2, 2, 64, 150, 168, False, 0, 0.0,
         1.0),
        ("Sq 130, Sk 70, causal", 2, 2, 130, 70, 168, True, 0, 0.0, 1.0),
        ("S 200, window 64", 2, 1, 200, 200, 168, True, 64, 0.0, 1.0),
        ("softcap 2.0, GQA BH 4 over 2, S 130, window 48", 4, 2, 130, 130,
         168, True, 48, 2.0, 2.0)), (
        ("GQA BH 8 over 4, lengths on split edges", 8, 4, 1024, 168, 0, 0.0,
         EDGES, 1.0),
        ("window 100 across split edges", 4, 4, 1024, 168, 100, 0.0,
         [150, 1024, 64, 1], 1.0),
        ("softcap 1.5, GQA BH 8 over 4", 8, 4, 1024, 168, 0, 1.5,
         [1024, 1024, 700, 3, 1, 64, 65, 1000], 2.0))),
}


def gemma_cases(kp, model):
    """A gemma3 model's shapes (``GEMMA_SHAPES``), new to the kernels, on
    inputs of a generator of their own. fused_rmsnorm at its d. Attention
    at its hd (240: 15 k-steps of 16, a key row of 30 bf16 / 60 f32
    16-byte vectors; 168: 11 k-steps, the last on columns zero-filled in
    shared memory, 21 / 42 vectors), its query heads over its KV heads:
    flash at S 600 causal in bf16 and f32, and at S 1500 with the local
    layers' window of 1024, where it binds (SDPA then takes the mask);
    decode at cache 1024, lengths 1024 (a local layer's full ring) and
    600, and a global layer's cache of 2048 at 1904; both kernels with a
    softcap that bends the scores (max |s| / cap in the label; no single
    PyTorch call computes the same). Then, untimed, in bf16 and f32, the
    edge cases of ``GEMMA_EDGES``, and at hd 168 the flash output written
    into a NaN-poisoned buffer (:func:`poisoned_flash`)."""
    d, bh, bh_kv, hd, seed = GEMMA_SHAPES[model]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    norm = kp["fused_rmsnorm"]
    for n in (1, 600, 1500):
        w = randn(d, dtype=f32, scale=0.1)
        x, w1 = randn(n, d), (1.0 + w).to(bf)
        yield Case("fused_rmsnorm", f"x ({n}, {d})",
                   lambda x=x, w=w: norm[0](x, w),
                   lambda x=x, w=w: norm[1](x, w),
                   lambda x=x, w1=w1, d=d: F.rms_norm(x, (d,), w1, eps=1e-6),
                   *costs.rmsnorm(n, d, bf), TOL, model=model)
    flash, decode = kp["flash_attention"], kp["decode_attention"]
    for s, window, dt in ((600, 0, bf), (600, 0, f32), (1500, 1024, bf)):
        q = randn(bh, s, hd, dtype=dt)
        k, v = randn(bh_kv, s, hd, dtype=dt), randn(bh_kv, s, hd, dtype=dt)
        i = torch.arange(s, device="cuda")
        keep = i[None, :] <= i[:, None]
        if window:
            keep &= i[None, :] > i[:, None] - window
        sdpa = (dict(is_causal=True) if not window else
                dict(attn_mask=keep[None, None]))
        yield Case(
            "flash_attention",
            f"BH {bh} over {bh_kv}, Sq = Sk = {s}, hd {hd}, causal"
            f"{f', window {window}' if window else ''}, {str(dt)[6:]}",
            lambda a=(q, k, v), w=window: flash[0](*a, window=w),
            lambda a=(q, k, v), w=window: flash[1](*a, window=w),
            lambda a=(q, k, v), kw=sdpa: F.scaled_dot_product_attention(
                *(t[None] for t in a), enable_gqa=True, **kw)[0],
            *costs.flash(bh, bh_kv, s, s, hd, dt, window=window),
            TOL if dt == bf else F32_TOL, model=model)
    yield from gqa_decode_cases(kp, randn, bh, bh_kv, hd, model)
    S, n = 2048, 1904
    q, k, v = randn(bh, 1, hd), randn(bh_kv, S, hd), randn(bh_kv, S, hd)
    lengths = torch.full((bh,), n, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda") < n)[None, None, None, :]
    yield Case(
        "decode_attention", f"BH {bh} over {bh_kv}, cache {S}, hd {hd}, "
        f"lengths {n}",
        lambda a=(q, k, v, lengths): decode[0](*a),
        lambda a=(q, k, v, lengths): decode[1](*a),
        lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=m, enable_gqa=True)[0],
        *costs.decode(bh, bh_kv, hd, bf, n * bh, n * bh_kv), TOL,
        model=model)
    cap, s, S = 2.0, 600, 1024
    q, k, v = randn(bh, s, hd), randn(bh_kv, s, hd), randn(bh_kv, s, hd)
    yield Case(
        "flash_attention",
        f"BH {bh} over {bh_kv}, Sq = Sk = {s}, hd {hd}, causal, softcap "
        f"{cap} (max |s| / cap {max_score(q, k) / cap:.2f}), bfloat16",
        lambda a=(q, k, v): flash[0](*a, softcap=cap),
        lambda a=(q, k, v): flash[1](*a, softcap=cap), None,
        *costs.flash(bh, bh_kv, s, s, hd, bf), TOL, model=model)
    q, k, v = randn(bh, 1, hd), randn(bh_kv, S, hd), randn(bh_kv, S, hd)
    lengths = torch.full((bh,), S, dtype=torch.int32, device="cuda")
    yield Case(
        "decode_attention", f"BH {bh} over {bh_kv}, cache {S}, hd {hd}, "
        f"lengths {S}, softcap {cap} (max |s| / cap "
        f"{max_score(q, k) / cap:.2f})",
        lambda a=(q, k, v, lengths): decode[0](*a, softcap=cap),
        lambda a=(q, k, v, lengths): decode[1](*a, softcap=cap), None,
        *costs.decode(bh, bh_kv, hd, bf, S * bh, S * bh_kv), TOL, model=model)
    flash_edges, decode_edges = GEMMA_EDGES[model]
    for dt, tol in ((bf, TOL), (f32, F32_TOL)):
        tag = str(dt)[6:]
        for label, bh, bh_kv, sq, sk, hd_e, causal, window, cap, sc in \
                flash_edges:
            q = randn(bh, sq, hd_e, dtype=dt, scale=sc)
            k, v = randn(bh_kv, sk, hd_e, dtype=dt, scale=sc), randn(
                bh_kv, sk, hd_e, dtype=dt)
            kw = dict(causal=causal, window=window, softcap=cap)
            bend = (f" (max |s| / cap {max_score(q, k) / cap:.2f})" if cap
                    else "")
            yield Case("flash_attention", f"{label}, hd {hd_e}{bend}, {tag}",
                       lambda a=(q, k, v), kw=kw: flash[0](*a, **kw),
                       lambda a=(q, k, v), kw=kw: flash[1](*a, **kw),
                       None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False)
        for label, bh, bh_kv, S, hd_e, window, cap, lens, sc in decode_edges:
            q = randn(bh, 1, hd_e, dtype=dt, scale=sc)
            k, v = randn(bh_kv, S, hd_e, dtype=dt, scale=sc), randn(
                bh_kv, S, hd_e, dtype=dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            kw = dict(window=window, softcap=cap)
            bend = (f" (max |s| / cap {max_score(q, k) / cap:.2f})" if cap
                    else "")
            yield Case("decode_attention", f"{label}, hd {hd_e}{bend}, {tag}",
                       lambda a=(q, k, v, lengths), kw=kw: decode[0](*a,
                                                                     **kw),
                       lambda a=(q, k, v, lengths), kw=kw: decode[1](*a,
                                                                     **kw),
                       None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False)
        if hd % 16:
            for sq, window in ((130, 0), (600, 0), (1500, 1024)):
                q = randn(4, sq, hd, dtype=dt)
                k, v = randn(2, sq, hd, dtype=dt), randn(2, sq, hd, dtype=dt)
                yield Case(
                    "flash_attention",
                    f"NaN-poisoned out, GQA BH 4 over 2, S {sq}"
                    f"{f', window {window}' if window else ''}, hd {hd}: "
                    f"every row, and 64 elements past the last still NaN, "
                    f"{tag}",
                    lambda a=(q, k, v), w=window: poisoned_flash(
                        flash[0], *a, window=w),
                    lambda a=(q, k, v), w=window: (
                        flash[1](*a, window=w), torch.ones(64,
                                                           device="cuda")),
                    None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False)


def poisoned_flash(kern, q, k, v, **kw):
    """The flash kernel writing into the head of a buffer of NaN with 64
    elements past q's: (its output, 1 where each element past the output
    is still NaN). A store past column hd - 1 of a row lands in the next
    row's first columns (held against the plain version there) or, from
    the last row, past the output (the tail)."""
    n = q.numel()
    buf = torch.full((n + 64,), float("nan"), dtype=q.dtype, device="cuda")
    out = kern(q, k, v, out=buf[:n].view(q.shape), **kw)
    return out, buf[n:].isnan().float()


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
    return run_cases(kernel_cases(kp), timer, {})


def run_cases(cases, timer, rows: dict) -> dict:
    """Checks each case's kernel against its plain version (and, for a
    ``bitwise`` case, a second call against the first), times the timed
    ones and keeps each kernel's JSON row in ``rows``."""
    for c in cases:
        out = c.kern()
        torch.cuda.synchronize()
        err, ok = max_err(out, c.plain(), c.tol)
        if not ok:
            fail(f"{c.name} [{c.label}]: kernel disagrees with its plain "
                 f"version, max |diff| {err:.3e} (tolerance {c.tol} * (1 + "
                 f"|plain|))")
        if c.bitwise:
            again = c.kern()
            if not all(torch.equal(a, b) for a, b in zip(
                    (out,) if isinstance(out, torch.Tensor) else out,
                    (again,) if isinstance(again, torch.Tensor) else again,
                    strict=True)):
                fail(f"{c.name} [{c.label}]: two calls differ in their bits")
            del again
        if not c.timed:
            print(f"kernel {c.name} [{c.label}]: max_abs_err {err:.3e} "
                  f"(tolerance {c.tol})", flush=True)
            continue
        # a plain version that takes seconds (rwkv6_scan's backward, a host
        # loop over the steps) is timed over SLOW_REPS calls
        t_plain = time.perf_counter()
        c.plain()
        torch.cuda.synchronize()
        slow = time.perf_counter() - t_plain > SLOW_PLAIN_S
        ms = timer(c.kern)
        plain_ms = (timer(c.plain, SLOW_REPS, 0) if slow else
                    timer(c.plain))
        lib_ms = lib_err = None
        if c.lib is not None:
            lib_err, _ = max_err(c.lib(), c.plain())
            lib_ms = timer(c.lib)
        if c.lib_ratio is not None:
            ref = c.plain()
            rel, lib_rel = norm_rel(out, ref), norm_rel(c.lib(), ref)
            print(f"kernel {c.name} [{c.label}]: ||kernel - plain|| / "
                  f"||plain|| {', '.join(f'{e:.3e}' for e in rel)}, the "
                  f"library's {', '.join(f'{e:.3e}' for e in lib_rel)} "
                  f"(at most {c.lib_ratio}x)", flush=True)
            if not all(a <= c.lib_ratio * b for a, b in zip(rel, lib_rel)):
                fail(f"{c.name} [{c.label}]: the kernel's norm-relative error "
                     f"{rel} is more than {c.lib_ratio}x the library's "
                     f"{lib_rel}")
            del ref
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


# -- phase 4b: the backward kernels against autograd through the plain versions

# the forward kernels' log-sum-exp: f32 at the kernel tolerance; the bf16
# kernel sums exp2 of log2-scaled scores and takes m ln 2 + ln l, an f32
# rounding away from the plain logsumexp of the same inputs' scores
LSE_TOL = {torch.float32: F32_TOL, torch.bfloat16: 1e-4}


def dw_tol(n: int) -> float:
    """dw sums n rows of f32 products (in either dtype): the rounding of
    such a sum grows as sqrt(n) in any order (the plain version's own dw
    is 4.5e-5 from the f64 sum at n 4096), so it is held at the f32
    kernel tolerance times sqrt(n)."""
    return F32_TOL * n ** 0.5


def retained_grad(out, inputs, grad):
    """A call computing d(out)/d(inputs) . grad on a graph built once (the
    backward alone, as a train step runs it)."""
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def backward_cases(rt):
    """The backward kernels at the training phase's shapes (deepseek-7b at
    full width: norms of (8192, 4096) rows of a microbatch and the
    decode-sized (1, 4096); attention at BH 64 = 2 x 32 heads, S 4096,
    hd 128, causal), in bf16 (the train step's dtype; the flash
    backward's tensor-core kernels) and f32 (its SIMT kernels), each
    against autograd through the plain version on the same inputs and
    twice for bitwise equality; gemma3's, listed apart (``TRAIN_SHAPES``,
    bf16, the dtype gemma3 trains in: norms of (8192, 3840) and (8192,
    5376), and the flash backward at hd 240, BH 32 over 16, and at hd
    168, BH 64 over 32, S 4096, causal and with the local layers' window
    of 1024); each bf16 flash backward row also held to BWD_LIB_RATIO
    times SDPA's norm-relative error; then untimed: the
    log-sum-exp of both forward kernels, and the whole attention backward
    at hd 16, 32, 64, 168 and 240, GQA G = 3, a window of 1024 at S 1500,
    and ragged S 1, 63, 65, 130. From a generator of their own, after the
    forward rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    kb = rt.backward

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    def norm_case(n, d, dt, tol, model=None):
        x, dy = randn(n, d, dtype=dt), randn(n, d, dtype=dt)
        w = randn(d, dtype=torch.float32, scale=0.1)
        xg, wg = (t.clone().requires_grad_(True) for t in (x, w))
        plain = retained_grad(kb["fused_rmsnorm_plain"](xg, wg), (xg, wg), dy)
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        lib_out = F.rms_norm(xl, (d,), (1.0 + wl).to(dt), eps=1e-6)
        return Case("fused_rmsnorm_bwd", f"x ({n}, {d}), {str(dt)[6:]}",
                    lambda: kb["fused_rmsnorm_bwd"](x, w, dy), plain,
                    retained_grad(lib_out, (xl, wl), dy),
                    *costs.rmsnorm_bwd(n, d, dt),
                    (tol, dw_tol(n)), serving=dt == torch.bfloat16,
                    bitwise=True, model=model)

    for dt, tol in ((torch.bfloat16, TOL), (torch.float32, F32_TOL)):
        tag = str(dt)[6:]
        for n in (8192, 1):
            yield norm_case(n, 4096, dt, tol)
        bh, s, hd = 64, 4096, 128
        q, k, v, do = (randn(bh, s, hd, dtype=dt) for _ in range(4))
        out, lse = kb["flash_lse"](q, k, v)
        delta = kb["flash_bwd_preprocess"](out, do)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        plain = retained_grad(kb["flash_plain"](qg, kg, vg), (qg, kg, vg), do)
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib = retained_grad(F.scaled_dot_product_attention(
            ql[None], kl[None], vl[None], is_causal=True)[0], (ql, kl, vl),
            do)
        label = f"BH {bh}, S {s}, hd {hd}, causal, {tag}"
        design = "tensor cores" if dt == torch.bfloat16 else "SIMT"
        serving = dt == torch.bfloat16
        yield Case("flash_bwd_preprocess", label,
                   lambda: kb["flash_bwd_preprocess"](out, do),
                   lambda: kb["flash_bwd_preprocess_plain"](out, do), None,
                   *costs.flash_bwd_preprocess(bh, s, hd, dt), tol,
                   serving=serving, bitwise=True)
        yield from flash_bwd_cases(kb, (q, k, v, do, lse, delta), plain, lib,
                                   f"{label}, {design}", tol, serving,
                                   lib_ratio=BWD_LIB_RATIO
                                   if serving else None)
        yield Case("flash_attention", f"lse, {label}",
                   lambda: kb["flash_lse"](q, k, v)[1],
                   lambda: kb["flash_lse_plain"](q, k), None, 0, 0,
                   costs.peak_rate(dt),
                   LSE_TOL[dt], timed=False, bitwise=True)
        del q, k, v, do, out, lse, delta, qg, kg, vg, ql, kl, vl, plain, lib
    bf = torch.bfloat16
    for model, (d, bh, bh_kv, hd) in TRAIN_SHAPES.items():
        yield norm_case(8192, d, bf, TOL, model)
        s = 4096
        for window in (0, 1024):
            q, do = randn(bh, s, hd, dtype=bf), randn(bh, s, hd, dtype=bf)
            k, v = randn(bh_kv, s, hd, dtype=bf), randn(bh_kv, s, hd, dtype=bf)
            out, lse = kb["flash_lse"](q, k, v, window=window)
            delta = kb["flash_bwd_preprocess"](out, do)
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            plain = retained_grad(kb["flash_plain"](qg, kg, vg, window=window),
                                  (qg, kg, vg), do)
            i = torch.arange(s, device="cuda")
            keep = i[None, :] <= i[:, None]
            if window:
                keep &= i[None, :] > i[:, None] - window
            sdpa = (dict(is_causal=True) if not window else
                    dict(attn_mask=keep[None, None]))
            ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
            lib = retained_grad(F.scaled_dot_product_attention(
                ql[None], kl[None], vl[None], enable_gqa=True, **sdpa)[0],
                (ql, kl, vl), do)
            label = (f"BH {bh} over {bh_kv}, S {s}, hd {hd}, causal"
                     f"{f', window {window}' if window else ''}, bf16, "
                     "tensor cores")
            yield from flash_bwd_cases(
                kb, (q, k, v, do, lse, delta), plain, lib, label, TOL, True,
                window, model, BWD_LIB_RATIO)
            del q, k, v, do, out, lse, delta, qg, kg, vg, ql, kl, vl, plain
            del lib, keep, sdpa
    edges = (("hd 16", 8, 8, 600, 16, 0), ("hd 32", 8, 8, 600, 32, 0),
             ("hd 64", 8, 8, 600, 64, 0), ("hd 168, G = 2", 16, 8, 600, 168, 0),
             ("hd 240, G = 2", 16, 8, 600, 240, 0),
             ("GQA G = 3", 24, 8, 600, 64, 0),
             ("window 1024, S 1500", 8, 8, 1500, 128, 1024),
             ("S 1", 4, 4, 1, 128, 0), ("S 63", 4, 4, 63, 128, 0),
             ("S 65", 4, 4, 65, 128, 0), ("S 130", 4, 4, 130, 128, 0))
    for dt, tol in ((torch.bfloat16, TOL), (torch.float32, F32_TOL)):
        for label, bh, bh_kv, s, hd, window in edges:
            q, do = randn(bh, s, hd, dtype=dt), randn(bh, s, hd, dtype=dt)
            k, v = randn(bh_kv, s, hd, dtype=dt), randn(bh_kv, s, hd, dtype=dt)
            yield Case("flash_bwd", f"dq, dk, dv, {label}, {str(dt)[6:]}",
                       lambda a=(q, k, v, do), w=window: kb["flash_grads"](
                           *a, window=w),
                       lambda a=(q, k, v, do), w=window: kb["flash_bwd_plain"](
                           *a, window=w),
                       None, 0, 0, BF16_FLOPS_PER_S, tol, timed=False,
                       bitwise=True)
            yield Case("flash_attention", f"lse, {label}, {str(dt)[6:]}",
                       lambda a=(q, k, v), w=window: kb["flash_lse"](
                           *a, window=w)[1],
                       lambda a=(q, k), w=window: kb["flash_lse_plain"](
                           *a, window=w),
                       None, 0, 0, BF16_FLOPS_PER_S, LSE_TOL[dt], timed=False)


def scan_backward_cases(rt):
    """The two scans' backward kernels at the training phase's shapes,
    each against autograd through the plain version on the same inputs
    and twice for bitwise equality: ssm_scan_bwd at zamba2-1.2b's
    microbatch (BH 128 = 2 x 64 heads over 2 B/C groups, S 4096, hd 64,
    ds 64, chunk 256, B/C bf16, the state's gradient zero as in training)
    and rwkv6_scan_bwd at rwkv6-1.6b's (BH 64 = 2 x 32 heads, u (32, 64),
    S 4096, hd 64, f32); f32 gradients within dw_tol(S) (of du, a sum over
    the steps of the 2 heads of a u row, dw_tol(2 S)), bf16 dB and dC
    within TOL. Then, untimed, the edge cases of the CPU design test
    (tests/test_torch_scan_grad.py): ragged S, chunk 1, S 1, B/C groups, a
    nonzero gradient of the final state, hd 128 / ds 128, B/C in f32, and
    a chunk whose log-decay spans more than 88 (every gradient finite);
    rwkv6 at S 1, 15, 16, 17 and 513, hd 16, 32 and 128, one u row, w at
    0 and 1, bf16. From a generator of their own, after the other
    backward rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    kb = rt.backward

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    def ssm_case(bh, bh_bc, s, hd, ds, chunk, dt, *, decay=0.2, dh=False,
                 timed=False):
        xbar, dy = randn(bh, s, hd, scale=0.5), randn(bh, s, hd)
        B, C = (randn(bh_bc, s, ds, scale=0.5, dtype=dt) for _ in range(2))
        cum = kb["chunk_cumsum"](-randn(bh, s, scale=decay).abs(), chunk)
        dhv = randn(bh, hd, ds) if dh else torch.zeros(bh, hd, ds,
                                                       device="cuda")
        ins = [t.clone().requires_grad_(True) for t in (xbar, B, C, cum)]
        plain = retained_grad(kb["ssm_plain"](*ins, chunk=chunk), ins,
                              (dy, dhv))
        tf = F32_TOL * s ** 0.5
        tol = (tf, TOL, TOL, tf) if dt == torch.bfloat16 else (tf,) * 4
        label = (f"BH {bh} over {bh_bc}, S {s}, hd {hd}, ds {ds}, chunk "
                 f"{chunk}, B/C {str(dt)[6:]}"
                 f"{', dh nonzero' if dh else ''}"
                 f"{f', log-decay {decay} a step' if decay > 1 else ''}")
        return Case("ssm_scan_bwd", label,
                    lambda: kb["ssm_bwd"](xbar, B, C, cum, dy, dhv,
                                          chunk=chunk),
                    plain, None,
                    *costs.ssm_bwd(bh, bh_bc, s, hd, ds, chunk, dt), tol,
                    timed=timed, bitwise=True)

    def rwkv_case(bh, n_u, s, hd, dt, *, extreme=False, dstate=False,
                  timed=False):
        r, k, v = (randn(bh, s, hd, scale=0.3, dtype=dt) for _ in range(3))
        if extreme:       # exact 0s and 1s: channels that forget, or never
            picks = torch.tensor([0.0, 1.0, 0.5, 0.9], device="cuda")
            w = picks[torch.randint(0, 4, (bh, s, hd), generator=gen,
                                    device="cuda")].to(dt)
        else:
            w = torch.sigmoid(randn(bh, s, hd)).to(dt)
        u, do = randn(n_u, hd, scale=0.1), randn(bh, s, hd, dtype=dt)
        ds = randn(bh, hd, hd) if dstate else torch.zeros(bh, hd, hd,
                                                          device="cuda")
        ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
        plain = retained_grad(kb["rwkv_plain"](*ins), ins, (do, ds))
        tf = F32_TOL * s ** 0.5
        tb = TOL if dt == torch.bfloat16 else tf
        tol = (tb,) * 4 + (F32_TOL * (s * bh // n_u) ** 0.5,)
        label = (f"BH {bh}, NU {n_u}, S {s}, hd {hd}, {str(dt)[6:]}"
                 f"{', w at 0 and 1' if extreme else ''}"
                 f"{', dS nonzero' if dstate else ''}")
        return Case("rwkv6_scan_bwd", label,
                    lambda: kb["rwkv_bwd"](r, k, v, w, u, do, ds), plain,
                    None, *costs.rwkv_bwd(bh, n_u, s, hd, dt), tol,
                    timed=timed, bitwise=True)

    bf, f32 = torch.bfloat16, torch.float32
    yield ssm_case(128, 2, 4096, 64, 64, 256, bf, timed=True)
    gc.collect()
    yield rwkv_case(64, 32, 4096, 64, f32, timed=True)
    gc.collect()
    for args, kw in (((2, 1, 300, 64, 64, 150), {}),
                     ((2, 2, 40, 32, 16, 1), {}),
                     ((2, 1, 1, 64, 64, 256), {}),
                     ((4, 2, 128, 64, 64, 64), {}),
                     ((2, 1, 200, 64, 32, 64), {"dh": True}),
                     ((2, 1, 130, 128, 128, 100), {"dh": True}),
                     ((2, 1, 128, 64, 64, 128), {"decay": 4.0})):
        for dt in (bf, f32):
            yield ssm_case(*args, dt, **kw)
    for args, kw in (((2, 2, 1, 64), {}), ((2, 2, 15, 32), {}),
                     ((2, 2, 16, 64), {}), ((4, 2, 17, 64), {"dstate": True}),
                     ((4, 2, 513, 64), {}), ((4, 4, 33, 16), {}),
                     ((2, 1, 40, 128), {"dstate": True}),
                     ((4, 2, 70, 64), {"extreme": True})):
        for dt in (f32, bf):
            yield rwkv_case(*args, dt, **kw)


def flash_bwd_cases(kb, args, plain, lib, label, tol, serving, window=0,
                    model=None, lib_ratio=None):
    """flash_bwd_dkdv (8 hd flops a live pair) and flash_bwd_dq (6 hd) on
    args = (q, k, v, dO, lse, D), causal, each against the dk, dv or dq of
    ``plain`` and ``lib`` (retained backward calls computing all three
    grads); bytes: each input read once (K and V once a KV head), each
    output written once (``costs.flash_bwd_dkdv``, ``flash_bwd_dq``)."""
    q, k = args[0], args[1]
    shape = (q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2],
             q.dtype, True, window)
    note = "(plain and library: all three grads)"
    yield Case("flash_bwd_dkdv", f"{label} {note}",
               lambda: kb["flash_bwd_dkdv"](*args, window=window),
               lambda: plain()[1:], lambda: lib()[1:],
               *costs.flash_bwd_dkdv(*shape), tol,
               serving=serving, bitwise=True, model=model,
               lib_ratio=lib_ratio)
    yield Case("flash_bwd_dq", f"{label} {note}",
               lambda: kb["flash_bwd_dq"](*args, window=window),
               lambda: plain()[0], lambda: lib()[0],
               *costs.flash_bwd_dq(*shape), tol,
               serving=serving, bitwise=True, model=model,
               lib_ratio=lib_ratio)


def flash_grads(rt, q, k, v, do, window=0):
    """(dq, dk, dv) of ``ops.flash_attention`` on the card through autograd:
    the forward kernel with its log-sum-exp and the three backward
    kernels."""
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    with rt.ops.uncounted():
        rt.ops.flash_attention(qg, kg, vg, window=window).backward(do)
    return qg.grad, kg.grad, vg.grad


def guard_checks(rt) -> None:
    """Kernels without a backward raise where a gradient is wanted, on the
    card, and never hand back an output without a grad_fn; the scans,
    which have one, hand back outputs with a grad_fn."""
    dev = "cuda"
    q = torch.randn(2, 1, 64, device=dev, requires_grad=True)
    k = torch.randn(2, 8, 64, device=dev)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=dev)
    qq = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    calls = {
        "decode_attention": lambda: rt.ops.decode_attention(q, k, k, lengths),
        "flash_attention (softcap 2.0)": lambda: rt.ops.flash_attention(
            qq, k, k, softcap=2.0),
    }
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            print(f"guard {name}: raises under grad ({e})", flush=True)
            continue
        fail(f"guard {name}: returned an output where a gradient is wanted")
    x = torch.randn(2, 16, 16, device=dev, requires_grad=True)
    w = torch.rand(2, 16, 16, device=dev)
    with rt.ops.uncounted():
        outs = {"ssm_scan": rt.ops.ssm_scan(x, w, w, torch.zeros(
                    2, 16, device=dev), chunk=16),
                "rwkv6_scan": rt.ops.rwkv6_scan(x, w, w, w, torch.zeros(
                    2, 16, device=dev))}
    for name, out in outs.items():
        if any(t.grad_fn is None for t in out):
            fail(f"guard {name}: an output without a grad_fn under grad")
        print(f"guard {name}: outputs carry {type(out[0].grad_fn).__name__}",
              flush=True)


def meta_alloc_checks(rt) -> None:
    """The dry run's meta route against the card: each kernel and backward
    kernel at the training shapes of its backward rows (deepseek-7b's
    norm and attention, gemma3-12b's attention at hd 240 over 16 KV heads
    with the window of 1024, zamba2-1.2b's and rwkv6-1.6b's scans; decode
    at deepseek-7b's serving shape), the forward kernels under grad (their
    saved tensors and log-sum-exps live): the bytes the call holds at its
    peak on meta (``dryrun.peak_of``, each allocation rounded to 512 as
    the caching allocator does) must equal its max_memory_allocated delta
    on the card."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    kb, ops = rt.backward, rt.ops
    G = (True,)                  # an input that requires grad

    def flash_in(bh, bh_kv, hd):
        return ((bh, 4096, hd, bf), (bh_kv, 4096, hd, bf),
                (bh_kv, 4096, hd, bf), (bh, 4096, hd, bf), (bh, 4096, f32),
                (bh, 4096, f32))
    ds_flash, gemma_flash = flash_in(64, 64, 128), flash_in(32, 16, 240)
    ssm_in = ((128, 4096, 64, f32), (2, 4096, 64, bf), (2, 4096, 64, bf),
              (128, 4096, f32), (128, 4096, 64, f32), (128, 64, 64, f32))
    rwkv_in = ((64, 4096, 64, f32),) * 4 + ((32, 64, f32),
                                            (64, 4096, 64, f32),
                                            (64, 64, 64, f32))
    cases = (
        ("fused_rmsnorm", "under grad, x (8192, 4096) bf16",
         ((8192, 4096, bf) + G, (4096, f32) + G), ops.fused_rmsnorm),
        ("fused_rmsnorm_bwd", "x (8192, 4096) bf16",
         ((8192, 4096, bf), (4096, f32), (8192, 4096, bf)),
         kb["fused_rmsnorm_bwd"]),
        ("flash_attention", "under grad, BH 64, S 4096, hd 128, bf16",
         tuple(t + G for t in ds_flash[:3]), ops.flash_attention),
        ("flash_attention", "under grad, BH 32 over 16, S 4096, hd 240, "
         "window 1024, bf16", tuple(t + G for t in gemma_flash[:3]),
         lambda q, k, v: ops.flash_attention(q, k, v, window=1024)),
        ("flash_bwd_preprocess", "BH 64, S 4096, hd 128, bf16",
         (ds_flash[0], ds_flash[3]), kb["flash_bwd_preprocess"]),
        ("flash_bwd_dkdv", "BH 64, S 4096, hd 128, bf16", ds_flash,
         kb["flash_bwd_dkdv"]),
        ("flash_bwd_dq", "BH 64, S 4096, hd 128, bf16", ds_flash,
         kb["flash_bwd_dq"]),
        ("flash_bwd_dkdv", "BH 32 over 16, S 4096, hd 240, window 1024, "
         "bf16", gemma_flash,
         lambda *a: kb["flash_bwd_dkdv"](*a, window=1024)),
        ("flash_bwd_dq", "BH 32 over 16, S 4096, hd 240, window 1024, bf16",
         gemma_flash, lambda *a: kb["flash_bwd_dq"](*a, window=1024)),
        ("decode_attention", "BH 32, cache 1024, hd 128, bf16",
         ((32, 1, 128, bf), (32, 1024, 128, bf), (32, 1024, 128, bf),
          (32, i32)), ops.decode_attention),
        ("ssm_scan", "under grad, BH 128 over 2, S 4096, hd 64, ds 64, "
         "chunk 256, B/C bf16", tuple(t + G for t in ssm_in[:4]),
         lambda *a: ops.ssm_scan(*a, chunk=256)),
        ("ssm_scan_bwd", "BH 128 over 2, S 4096, hd 64, ds 64, chunk 256, "
         "B/C bf16", ssm_in, lambda *a: kb["ssm_bwd"](*a, chunk=256)),
        ("rwkv6_scan", "under grad, BH 64, NU 32, S 4096, hd 64, f32",
         tuple(t + G for t in rwkv_in[:5]), ops.rwkv6_scan),
        ("rwkv6_scan_bwd", "BH 64, NU 32, S 4096, hd 64, f32", rwkv_in,
         kb["rwkv_bwd"]))

    def make(specs, device):
        out = []
        for spec in specs:
            grad = spec[-1] is True
            *shape, dt = spec[:-1] if grad else spec
            t = (torch.ones(shape, dtype=dt, device=device) if dt == i32
                 else torch.rand(shape, device=device).to(dt))
            out.append(t.requires_grad_(grad))
        return tuple(out)

    for name, label, specs, call in cases:
        ins = make(specs, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with ops.uncounted():
            out = call(*ins)
        torch.cuda.synchronize()
        card = torch.cuda.max_memory_allocated() - base
        del out, ins
        meta_ins = make(specs, "meta")
        pred = rt.dryrun.peak_of(lambda: call(*meta_ins), meta_ins)
        print(f"meta alloc {name} [{label}]: meta {pred} B, card {card} B",
              flush=True)
        if pred != card:
            fail(f"{name} [{label}]: the meta route holds {pred} bytes at "
                 f"its peak, the card's call {card}")
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 5: training deepseek-7b and gemma3-12b at full width ---------------

TRAIN_ARCH = "deepseek-7b"
TRAIN_LAYERS = 12          # 3.267 B parameters, 52.3 GB of f32 state
CHECK_LAYERS = 2           # the kernel-vs-plain, resume and remat checks
TRAIN_STEPS = 5            # the last one traced
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = 4096, 4, 2    # train_4k; 16,384 tokens
# gemma3-12b: one group of 5 local layers (window 1024) and a global one,
# 2.33 B parameters, 37 GB of f32 state; 3 steps, the last traced
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS = 6, 3
# zamba2-1.2b (38 layers, 1.104 B parameters, 17.7 GB of f32 state) and
# rwkv6-1.6b (24 layers, 1.483 B, 23.7 GB) at full width and depth: 3
# steps, the last traced
SCAN_TRAIN_ARCHS, SCAN_TRAIN_STEPS = ("zamba2-1.2b", "rwkv6-1.6b"), 3
# the dry run's predicted train peak: within this share of the measured one
DRY_RUN_TOL = 0.05
# a microbatch's shapes of gemma3's train steps: (d, BH, BH_kv, hd)
TRAIN_SHAPES = {GEMMA: (3840, 32, 16, 240), GEMMA27: (5376, 64, 32, 168)}


def train_config(rt, steps: int):
    return rt.TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps,
                          microbatches=TRAIN_MB)


def train_model(rt, n_layers: int, dtype=torch.bfloat16, kernels=None,
                params=None, arch=TRAIN_ARCH):
    cfg = rt.configs.get_config(arch).with_(n_layers=n_layers)
    if params is None:
        params = rt.init_params(cfg, seed=SEED, device="cuda",
                                dtype=torch.float32)
    return rt.LM.from_params(cfg, params, dtype=dtype,
                             kernels=kernels or rt.ops)


def train_launches(rt, cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps of TRAIN_MB microbatches
    with remat: each norm, attention and scan inside a checkpoint runs
    forward twice (the forward, the recomputation) and backward once; the
    final norm is outside the checkpoints. A transformer layer holds two
    norms and attention; a zamba2 Mamba layer two norms and ssm_scan, and
    its shared block (two norms and attention) runs after every group of
    layers; an rwkv6 layer three norms and rwkv6_scan."""
    L, n = cfg.n_layers, steps * TRAIN_MB
    kind = rt.family_kind(cfg)
    scans = {}
    if kind == "zamba":
        shared = rt.zamba_groups(cfg)[0]
        norms, attn, scans = 2 * L + 2 * shared, shared, {"ssm_scan": L}
    elif kind == "rwkv":
        norms, attn, scans = 3 * L, 0, {"rwkv6_scan": L}
    else:
        norms, attn = 2 * L, L
    out = {"fused_rmsnorm": (2 * norms + 1) * n,
           "fused_rmsnorm_bwd": (norms + 1) * n,
           "flash_attention": 2 * attn * n, "flash_bwd_preprocess": attn * n,
           "flash_bwd_dkdv": attn * n, "flash_bwd_dq": attn * n}
    for name, k in scans.items():
        out[name], out[f"{name}_bwd"] = 2 * k * n, k * n
    return out


def train_phase(rt, smi: str, arch: str = TRAIN_ARCH,
                n_layers: int = TRAIN_LAYERS, steps: int = TRAIN_STEPS
                ) -> dict:
    """(c): ``arch`` at full width, ``n_layers`` layers, trains ``steps``
    steps of batch 4 x 4096 tokens in 2 microbatches through
    make_train_step; the launch counts set to 0 just before and read just
    after. Before it, the dry run reckons the same step on the host (meta
    device); its peak, plus what is live on the card as the phase
    starts, must lie within DRY_RUN_TOL of the phase's
    max_memory_allocated."""
    t0 = time.perf_counter()
    dry = rt.dryrun.run_cell(arch, "train_4k", layers=n_layers,
                             batch=TRAIN_BATCH, microbatches=TRAIN_MB)
    dry_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_phase = t0 = time.perf_counter()
    lm = train_model(rt, n_layers, arch=arch)
    cfg = lm.cfg
    params = dict(lm.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    opt = rt.init_opt_state(params)
    torch.cuda.synchronize()
    full = rt.configs.get_config(arch).n_layers
    kind = rt.family_kind(cfg)
    if kind == "rwkv":
        heads = (f"{cfg.d_model // cfg.rwkv_head_dim} RWKV6 heads of "
                 f"{cfg.rwkv_head_dim}")
    else:
        heads = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
                 f"{cfg.hd}")
    if kind == "zamba":
        _, nh, hd, ds = rt.ssm_dims(cfg)
        heads = (f"{nh} SSM heads of {hd}, ds {ds}, chunk "
                 f"{min(cfg.ssm_chunk, TRAIN_SEQ)}; the shared block ("
                 f"{heads}) after every {cfg.shared_attn_every} layers")
    print(f"train {cfg.name}: {cfg.n_layers} of {full} layers, d_model "
          f"{cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          f"{f', window {cfg.local_window}' if cfg.local_window else ''}: "
          f"{n_params / 1e9:.3f} B parameters, f32 masters + grads + m + v "
          f"{16 * n_params / 1e9:.1f} GB; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tcfg = train_config(rt, steps)
    data = rt.SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          batch=TRAIN_BATCH, seed=SEED, device="cuda")
    step_fn = rt.make_train_step(lm, tcfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    parts = rt.dryrun.train_flops(cfg, tokens, TRAIN_SEQ)
    flops = sum(parts.values())
    print(f"train {cfg.name}: model FLOPs a step {flops / 1e12:.1f} T = "
          + " + ".join(f"{k} {v / 1e12:.1f}" for k, v in parts.items()),
          flush=True)
    losses, walls = [], []
    rt.ops.reset_launch_counts()
    for step in range(steps):
        batch = data.next_batch()
        traced = step == steps - 1
        torch.cuda.synchronize()
        if traced:
            wall_ms, by_kernel = traced_step(rt, lambda: step_fn(opt, batch))
            opt, metrics = by_kernel.pop("result")
            wall = wall_ms / 1e3
        else:
            t0 = time.perf_counter()
            opt, metrics = step_fn(opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        loss = float(metrics["loss"])
        losses.append(loss)
        walls.append(wall)
        print(f"train step {step}: loss {loss:.4f} lr {metrics['lr']:.3e} "
              f"gnorm {float(metrics['grad_norm']):.4f} wall {wall:.3f} s"
              f"{' (traced)' if traced else ''}; {tokens / wall:.0f} tokens/s,"
              f" model {flops / wall / 1e12:.1f} TFLOP/s "
              f"({flops / wall / BF16_FLOPS_PER_S:.3f} of 989)", flush=True)
    counts = rt.ops.launch_counts()
    expect = train_launches(rt, cfg, steps)
    for name, n in counts.items():
        if n != expect.get(name, 0):
            fail(f"train {cfg.name}: kernel {name}: {n} launches, the train "
                 f"steps make {expect.get(name, 0)}")
    print(f"train launches {counts}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"train {cfg.name}: losses {losses} not finite")
    # the scan families' random-init losses sit at ln(vocab) (zamba2-1.2b
    # on an H100: 10.4123 at step 0 against ln 32000 = 10.3735), where
    # three steps on three batches move them less than the batches differ
    # (10.4123, 10.4145, 10.4125): their losses must be finite, and the
    # transformer families' must also fall
    if kind in ("uniform", "local_global") and not losses[-1] < losses[0]:
        fail(f"train {cfg.name}: losses {losses} not falling")
    no_grad = [n for n, p in params.items()
               if p.grad is None or not bool(p.grad.isfinite().all())
               or not bool(p.grad.abs().max() > 0)]
    if no_grad:
        fail(f"train {cfg.name}: {len(no_grad)} parameters without a "
             f"finite non-zero gradient, e.g. {no_grad[:4]}")
    untraced = walls[1:-1]
    wall = statistics.median(untraced)
    busy, bwd = by_kernel["busy"], by_kernel["bwd"]
    flash_bwd = sum(ms for k, ms in bwd.items() if k.startswith("flash"))
    scan_bwd = sum(ms for k, ms in bwd.items()
                   if k.startswith(("ssm_bwd", "rwkv6_bwd", "sum_partials")))
    print(f"train {cfg.name} ({smi}): step wall median {wall:.3f} s of "
          f"steps {'1' if steps == 3 else f'1-{steps - 2}'} (step 0 "
          f"{walls[0]:.3f} s), "
          f"{tokens / wall:.0f} tokens/s, model {flops / wall / 1e12:.1f} "
          f"TFLOP/s = {flops / wall / BF16_FLOPS_PER_S:.3f} of 989 "
          f"({flops / 1e12:.1f} TFLOP a step); traced step busy "
          f"{busy:.1f} ms of {walls[-1] * 1e3:.1f} ms wall (idle "
          f"{1 - busy / (walls[-1] * 1e3):.3f}); backward kernels "
          + ", ".join(f"{k} {ms:.1f} ms ({ms / (walls[-1] * 1e3):.3f} of "
                      "the wall)" for k, ms in bwd.items())
          + f"; the flash backward {flash_bwd:.1f} ms "
          f"({flash_bwd / (walls[-1] * 1e3):.3f}), the scans' backward "
          f"{scan_bwd:.1f} ms ({scan_bwd / (walls[-1] * 1e3):.3f}); every "
          f"one of {len(params)} parameters has a finite, non-zero "
          f"gradient; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    for name, ms, calls in by_kernel["top"]:
        print(f"train kernel {name[:90]}: {ms:.1f} ms in {calls} calls",
              flush=True)
    peak = torch.cuda.max_memory_allocated()
    pred = dry["peak_bytes"] + base
    gap = pred - peak
    dry_flops = dry["hlo_flops_dev"]
    print(f"train {cfg.name} dry run (host, meta device, {dry_s:.1f} s): "
          f"predicted peak {dry['peak_bytes'] / 1e9:.3f} GB + "
          f"{base / 1e9:.3f} GB live as the phase starts = {pred / 1e9:.3f}"
          f" GB, measured max_memory_allocated {peak / 1e9:.3f} GB, gap "
          f"{gap / 1e9:+.3f} GB ({gap / peak:+.4f} of measured, limit "
          f"{DRY_RUN_TOL}); predicted {dry_flops / 1e12:.1f} TFLOP a step "
          f"(aten and kernels, remat included), {dry_flops / wall / 1e12:.1f}"
          f" TFLOP/s at the measured median wall; t_compute "
          f"{dry['t_compute']:.3f} s, t_memory {dry['t_memory']:.3f} s, "
          f"bottleneck {dry['bottleneck']}", flush=True)
    if abs(gap) > DRY_RUN_TOL * peak:
        fail(f"train {cfg.name}: the dry run's peak {pred} B is more than "
             f"{DRY_RUN_TOL} of the measured {peak} B away")
    total = torch.cuda.get_device_properties(0).total_memory
    free, _ = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    print(f"train {cfg.name} capacity: total_memory {total} B (the dry "
          f"run's {HBM_BYTES} B), {outside} B outside the caching allocator "
          f"(the dry run leaves {HBM_OUTSIDE_ALLOCATOR} B), max reserved "
          f"{torch.cuda.max_memory_reserved()} B", flush=True)
    if total != HBM_BYTES:
        fail(f"the card holds {total} B, the dry run's capacity is "
             f"{HBM_BYTES} B")
    if outside > HBM_OUTSIDE_ALLOCATOR:
        fail(f"train {cfg.name}: {outside} B outside the caching allocator, "
             f"the dry run leaves {HBM_OUTSIDE_ALLOCATOR} B")
    del lm, params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def traced_step(rt, fn):
    """One step under torch.profiler: (wall ms, {"busy": device ms,
    "bwd": {kernel group: device ms}, "top": the 8 longest kernels,
    "result": fn's result})."""
    prof = rt.profile
    result = {}
    wall_ms, by_group, kernels = prof.traced(
        lambda: result.setdefault("r", fn()))
    bwd = {"flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0,
           "flash_bwd_preprocess": 0.0, "rmsnorm_bwd_rows": 0.0,
           "rmsnorm_bwd_dw": 0.0, "rmsnorm_bwd_loop": 0.0,
           "ssm_bwd_prep_kernel": 0.0, "ssm_bwd_carry_kernel": 0.0,
           "ssm_bwd_chunk_kernel": 0.0, "rwkv6_bwd_sum_kernel": 0.0,
           "rwkv6_bwd_carry_kernel": 0.0, "rwkv6_bwd_chunk_kernel": 0.0,
           "sum_partials_kernel": 0.0,
           # a parent tree's (PR 27's) scan backward, timed by this script
           "ssm_bwd_state_kernel": 0.0, "rwkv6_bwd_kernel": 0.0}
    for name, ms, _ in kernels:
        for key in bwd:
            if key in name:
                bwd[key] += ms
    bwd = {k: ms for k, ms in bwd.items() if ms > 0}
    return wall_ms, {"busy": sum(ms for _, ms, _ in kernels), "bwd": bwd,
                     "top": kernels[:8], "result": result["r"]}


def grads_of(rt, lm, batch, remat=True):
    """(loss, {name: f32 grad copy}) of one step's microbatches."""
    for p in lm.parameters():
        p.requires_grad_(True)
    loss, grads = rt.loss_and_grads(lm, batch, train_config(rt, 1), remat)
    out = {n: g.clone() for n, g in grads.items()}
    for p in lm.parameters():
        p.grad = None
    return float(loss), out


def rel_grad(a: dict, b: dict) -> dict:
    """max |a - b| / max |b| of each leaf."""
    return {n: float((a[n] - b[n]).abs().max())
            / max(float(b[n].abs().max()), 1e-30) for n in b}


def train_checks(rt) -> None:
    """(d)-(f) at full width, the depth cut to CHECK_LAYERS: step 0's loss
    and gradients through the kernels against the plain path (bf16 within
    the noise floor measured here, f32 at F32_PATH_TOL); resume from a
    checkpoint bitwise; remat bitwise."""
    t0 = time.perf_counter()
    cfg = rt.configs.get_config(TRAIN_ARCH).with_(n_layers=CHECK_LAYERS)
    params = rt.init_params(cfg, seed=SEED, device="cuda",
                            dtype=torch.float32)
    batch = rt.SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           batch=TRAIN_BATCH, seed=SEED,
                           device="cuda").next_batch()
    paths = {}
    for key, dt, kern in (("k16", torch.bfloat16, rt.ops),
                          ("p16", torch.bfloat16, rt.plain),
                          ("k32", torch.float32, rt.ops),
                          ("p32", torch.float32, rt.plain)):
        with rt.ops.uncounted():
            paths[key] = grads_of(rt, train_model(
                rt, CHECK_LAYERS, dt, kern, params), batch)
    (l_k16, g_k16), (l_p16, g_p16) = paths["k16"], paths["p16"]
    (l_k32, g_k32), (l_p32, g_p32) = paths["k32"], paths["p32"]
    f32_rel = abs(l_k32 - l_p32) / abs(l_p32)
    k16_rel = abs(l_k16 - l_p32) / abs(l_p32)
    p16_rel = abs(l_p16 - l_p32) / abs(l_p32)
    loss_tol = max(F32_PATH_TOL, 2.0 * p16_rel)
    print(f"train path check ({CHECK_LAYERS} layers, step 0): loss kernel/"
          f"plain bf16 {l_k16:.6f}/{l_p16:.6f}, f32 {l_k32:.6f}/{l_p32:.6f};"
          f" f32 |kernel - plain| {f32_rel:.3e} (tolerance {F32_PATH_TOL}); "
          f"bf16 |kernel - f32| {k16_rel:.3e}, noise floor |plain - f32| "
          f"{p16_rel:.3e} (tolerance {loss_tol:.3e})", flush=True)
    if f32_rel > F32_PATH_TOL or k16_rel > loss_tol:
        fail("train path check: the kernel path's loss is off the plain "
             "path's")
    # each leaf's floor is the bf16 plain path's distance from the f32
    # plain path: the random weights (std 1 / sqrt(layers) by materialize's
    # rule) saturate the softmax, where dS = P (dP - D) cancels and a
    # leaf's gradient can be mostly amplified rounding (the embedding's)
    r32, r16 = rel_grad(g_k32, g_p32), rel_grad(g_k16, g_p32)
    floor = rel_grad(g_p16, g_p32)
    bad = []
    for n in g_p32:
        tol32 = max(F32_PATH_TOL, floor[n])
        tol16 = max(PATH_TOL, 2.0 * floor[n])
        print(f"train grad {n}: f32 |kernel - plain| {r32[n]:.3e} (tolerance"
              f" {tol32:.3e}); bf16 |kernel - f32| {r16[n]:.3e} (tolerance "
              f"{tol16:.3e}); floor |bf16 plain - f32| {floor[n]:.3e}; "
              f"bf16 |kernel - plain| "
              f"{rel_grad({n: g_k16[n]}, {n: g_p16[n]})[n]:.3e} (of max |g|)",
              flush=True)
        if not (bool(g_k16[n].isfinite().all())
                and bool(g_k32[n].isfinite().all())) \
                or r32[n] > tol32 or r16[n] > tol16:
            bad.append(n)
    if bad:
        fail(f"train grads {bad}: the kernel path's gradients are off the "
             "plain path's beyond the noise floor")
    del paths, g_k32, g_p32, g_p16, g_k16
    # (f) remat: the same grads with and without the recomputation
    lm = train_model(rt, CHECK_LAYERS, params=params)
    with rt.ops.uncounted():
        l_a, g_a = grads_of(rt, lm, batch, remat=True)
        l_b, g_b = grads_of(rt, lm, batch, remat=False)
    same = [n for n in g_a if torch.equal(g_a[n], g_b[n])]
    print(f"train remat check: loss {l_a!r} / {l_b!r} with / without remat;"
          f" {len(same)} of {len(g_a)} gradients bitwise equal", flush=True)
    if l_a != l_b or len(same) != len(g_a):
        fail("train remat check: remat changes the gradients")
    del g_a, g_b, lm
    resume_check(rt, cfg, params)
    print(f"train checks {time.perf_counter() - t0:.1f} s", flush=True)


def resume_check(rt, cfg, params) -> None:
    """(e): 4 steps uninterrupted, against 3 steps, a checkpoint (saved on
    a thread while step 3 runs), a fresh model and optimizer restored from
    it, and step 3 again: the same bits."""
    steps = 4
    tcfg = train_config(rt, steps)
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = rt.CheckpointManager(str(ckdir), keep=1, async_save=True)

    def run(lm, opt, data, first, last):
        step_fn = rt.make_train_step(lm, tcfg)
        out = None
        for step in range(first, last):
            opt, out = step_fn(opt, data.next_batch())
            if step == 2:
                t0 = time.perf_counter()
                mgr.save(step + 1, rt.train_state(lm, opt, data.state_dict()))
                print(f"train resume: state copied to the host in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        return opt, out

    pa = {n: t.clone() for n, t in params.items()}
    lm = train_model(rt, CHECK_LAYERS, params=pa)
    data = rt.SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          batch=TRAIN_BATCH, seed=SEED, device="cuda")
    with rt.ops.uncounted():
        _, out_a = run(lm, rt.init_opt_state(pa), data, 0, steps)
    t0 = time.perf_counter()
    mgr.wait()
    print(f"train resume: checkpoint written {time.perf_counter() - t0:.1f}"
          f" s after step 3 ended", flush=True)
    loss_a = float(out_a["loss"])
    del lm, out_a
    gc.collect()
    torch.cuda.empty_cache()
    pb = {n: torch.zeros_like(t) for n, t in params.items()}
    lm = train_model(rt, CHECK_LAYERS, params=pb)
    opt = rt.init_opt_state(pb)
    t0 = time.perf_counter()
    latest, state = mgr.restore_latest(rt.state_like(cfg))
    if latest != 3:
        fail(f"train resume: restored step {latest}, expected 3")
    opt, data_state = rt.load_train_state(state, lm, opt)
    del state
    data = rt.SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          batch=TRAIN_BATCH, device="cuda")
    data.load_state(data_state)
    print(f"train resume: step {latest} restored in "
          f"{time.perf_counter() - t0:.1f} s (hash {mgr.meta(3)['hash'][:16]})",
          flush=True)
    with rt.ops.uncounted():
        _, out_b = run(lm, opt, data, latest, steps)
    differ = [n for n in pa if not torch.equal(pa[n], pb[n])]
    print(f"train resume: step 3 loss {loss_a!r} uninterrupted, "
          f"{float(out_b['loss'])!r} resumed; {len(pa) - len(differ)} of "
          f"{len(pa)} parameters bitwise equal after it", flush=True)
    if differ or loss_a != float(out_b["loss"]):
        fail(f"train resume: step 3 differs after the restore ({differ[:4]})")
    shutil.rmtree(ckdir, ignore_errors=True)


# -- phase 3: tensor-core instructions in the build ----------------------------

SASS_KERNELS = ("flash_tc_kernel", "flash_f32_kernel", "decode_split_kernel",
                "decode_combine_kernel", "ssm_tc_kernel", "ssm_scan_kernel",
                "rwkv6_chunk_kernel", "flash_bwd_dkdv_tc_kernel",
                "flash_bwd_dq_tc_kernel", "ssm_bwd_prep_kernel",
                "ssm_bwd_chunk_kernel")
# must show HMMA/HGMMA (every instance: the ssm backward's f32 ones too)
TENSOR_CORE_KERNELS = ("flash_tc", "ssm_tc", "flash_bwd_dkdv_tc",
                       "flash_bwd_dq_tc", "ssm_bwd_prep", "ssm_bwd_chunk")
BWD_TC_HEAD_DIMS = (16, 32, 64, 128, 168, 240)   # the backward's bf16 hds


def sass_check(lib_path: Path, head_dims: tuple) -> None:
    """Count HMMA (mma.sync) and HGMMA (wgmma) instructions in the SASS of
    each attention and scan kernel (<n, ..> are the template's head or
    state dims); the bf16 flash and ssm kernels and every instance of the
    ssm backward's two product kernels (bf16 and f32 B/C, each hd and
    ds) must have some, the bf16 flash kernel must be there at every
    head dim of ``head_dims`` (168: padded to 176 inside it) with and
    without the softcap, and the flash backward's two tensor-core
    kernels at every head dim of BWD_TC_HEAD_DIMS (the rwkv6 kernel runs
    on the CUDA cores and is listed for its count)."""
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
            dims = ",".join(re.findall(r"Li(\d+)E", fn))
            fn = (f"{m.group(0)}<{dims}> "
                  f"{'bf16' if 'bfloat16' in fn else 'f32'}"
                  f"{', softcap' if 'Lb1E' in fn else ''}") if m else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    for name, n in sorted(counts.items()):
        print(f"sass: {name}: {n} HMMA/HGMMA", flush=True)
    for kernel in TENSOR_CORE_KERNELS:
        tc = [n for name, n in counts.items() if name.startswith(kernel)]
        if not tc or min(tc) == 0:
            fail(f"an instance of {kernel}_kernel has no tensor-core "
                 "instruction in its SASS")
    for hd in head_dims:
        for cap in ("", ", softcap"):
            if not counts.get(f"flash_tc_kernel<{hd}> bf16{cap}"):
                fail(f"flash_tc_kernel<{hd}> bf16{cap}: not in the SASS, or "
                     "no tensor-core instruction")
    for kernel in ("flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel"):
        for hd in BWD_TC_HEAD_DIMS:
            if not counts.get(f"{kernel}<{hd}> bf16"):
                fail(f"{kernel}<{hd}> bf16: not in the SASS, or no "
                     "tensor-core instruction")
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
          MOONSHOT, GEMMA, GEMMA27)
PROMPT_LENS = (32, 600, 77, 513, 200, 45, 333, 128)
MAX_LEN = 1024
# gemma3: its local layers keep a window of 1024 keys in ring caches,
# so its prompts cross the window: 1020 (decode wraps the ring), 1024 (=
# W), 1500 and 1900 (> W, not a multiple: prefill wraps it), at max_len
# 2048; some below 600
GEMMAS = (GEMMA, GEMMA27)
MODEL_PROMPTS = {m: (32, 1020, 1500, 1024, 200, 1900, 77, 513)
                 for m in GEMMAS}
MODEL_MAX_LEN = {m: 2048 for m in GEMMAS}
# prefill lengths timed (the decode step is timed after the longest)
STEP_PROMPTS = {m: (513, 1500) for m in GEMMAS}
# prompt of the f32 graph check (gemma3: past the window) and of the
# path check (gemma3: the window binds in prefill, decode past it)
GRAPH_PROMPT = {m: 1100 for m in GEMMAS}
PATH_PROMPT = {m: 1500 for m in GEMMAS}


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
    # uniform, and local_global: local and global layers alike make one
    # flash (windowed or not) a prefill and one decode (ring or linear
    # cache) a step
    return {"fused_rmsnorm": (2 * L + 1) * steps,
            "flash_attention": L * n_prefill,
            "decode_attention": L * n_decode}


def serving_phase(rt, cfg, params):
    """Serves the 8 requests; returns (launch counts, completed requests,
    the engine's LM)."""
    t0 = time.perf_counter()
    prompts = MODEL_PROMPTS.get(cfg.name, PROMPT_LENS)
    eng = rt.ServingEngine(cfg, params, n_slots=4, n_fifo=2,
                           max_len=MODEL_MAX_LEN.get(cfg.name, MAX_LEN),
                           initial_limit_ms=40.0, device="cuda")
    torch.cuda.synchronize()
    if any(g is None for g in eng.decoder.graphs):
        fail(f"{cfg.name}: a slot of the engine has no captured decode step")
    print(f"engine {cfg.name}: {eng.n_slots} decode graphs captured in "
          f"{time.perf_counter() - t0:.2f} s; launches a replay "
          f"{eng.decoder.graphs[0].launches}", flush=True)
    rng = np.random.default_rng(SEED + 1)
    for rid, n in enumerate(prompts):
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
    n_prefill = len(prompts)
    n_decode = sum(len(r.generated) - 1 for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={prompts[r.rid]} "
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


def cache_check(rt, lm, cfg) -> None:
    """The bytes the dry run reckons for a slot's cache (``cache_specs``,
    each leaf rounded to 512) against what ``new_cache`` allocates on the
    card. ``new_cache`` allocates from ``cache_specs`` itself, so this
    checks only that the card's allocator rounds as ``alloc_bytes``
    does; the tie to JAX's cache layout is the CPU test
    ``test_new_cache_bytes_are_jax_s``."""
    max_len = MODEL_MAX_LEN.get(cfg.name, MAX_LEN)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache = lm.new_cache(1, max_len)
    torch.cuda.synchronize()
    card = torch.cuda.memory_allocated() - before
    del cache
    pred = rt.dryrun.cache_bytes(cfg, 1, max_len, lm.dtype)
    print(f"cache {cfg.name}: new_cache(1, {max_len}) allocates {card} B on "
          f"the card, the dry run reckons {pred} B", flush=True)
    if pred != card:
        fail(f"{cfg.name}: new_cache allocates {card} B, the dry run "
             f"reckons {pred} B")


def redecode_check(lm, cfg, done) -> None:
    """The engine's tokens (graph replays, slots swapped on preemption)
    against an eager greedy decode of each request on its own cache."""
    with torch.inference_mode():
        for r in done:
            logits, cache = lm.prefill(r.tokens,
                                       MODEL_MAX_LEN.get(cfg.name, MAX_LEN))
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
    """Host-clock time of one prefill (of 513 tokens, for gemma3-12b also
    of 1500) and of one decode step after the longest, eager and as a
    graph replay, taken in turns; a step is the engine's work for one
    token (the step, then the greedy token read on the host, which
    synchronises). The device's busy and idle share within them is read by
    ``python -m repro_torch.launch.profile --arch``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    max_len = MODEL_MAX_LEN.get(cfg.name, MAX_LEN)
    dec = rt.SlotDecoder(lm, 1, max_len)
    prefill_ms = {}
    with torch.inference_mode():
        for n in STEP_PROMPTS.get(cfg.name, (513,)):
            toks = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                                 device="cuda")
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, cache = lm.prefill(toks, max_len)
                torch.cuda.synchronize()
                prefill_ms[n] = (time.perf_counter() - t0) * 1e3
        dec.prefill(0, toks)
        tok = int(toks[0, -1])
        tok_t = toks[:, -1]
        pos_t = torch.tensor([n], device="cuda")
        walls = {"eager": [], "graph": []}
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(torch.argmax(lm.decode_step(tok_t, cache, pos_t)[0][0, -1]))
            walls["eager"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(torch.argmax(dec.step(0, tok, n)[0, -1]))
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
    prefills = ", ".join(f"prefill {k} tokens {ms:.2f} ms wall"
                         for k, ms in prefill_ms.items())
    print(f"step {cfg.name}: {prefills}; decode step (cache {n + 1}) eager "
          f"{eager_ms:.3f} ms, graph replay {graph_ms:.3f} ms wall (medians "
          f"of 10, in turns); weight-read bound of a decode step {floor}; "
          f"the engine bills {cfg.ms_per_token_decode} ms a token "
          f"(ms_per_token_decode)", flush=True)


def graph_check(rt, cfg, params32) -> None:
    """The captured decode step against the eager LM.decode_step in f32 at
    full width (``cfg`` may be cut in depth): a 200-token prompt
    (gemma3-12b: 1100, past its window) prefilled into slot 0 and into a
    twin cache, then 4 greedy steps; before the third the request is
    saved out of slot 0, slot 0 is filled with NaN, and the state is
    loaded into slot 1. Each replay must equal the eager step bitwise, or
    lie within GRAPH_TOL of the logits' scale."""
    lm = rt.LM.from_params(cfg, params32)
    max_len = MODEL_MAX_LEN.get(cfg.name, MAX_LEN)
    n = GRAPH_PROMPT.get(cfg.name, 200)
    dec = rt.SlotDecoder(lm, 2, max_len)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        logits, twin = lm.prefill(prompt, max_len)
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
            got = dec.step(slot, tok, n + i).clone()
            want, twin = lm.decode_step(
                torch.tensor([tok], device="cuda"), twin,
                torch.tensor([n + i], device="cuda"))
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
# gemma3-12b: its f32 twin at full depth (~46 GB) beside the bf16 model
# (25.3 GB) would leave no room for the checks, so they take its first
# group (5 local layers and the global one) and the next local layer,
# where every kind of layer and both cache layouts run.
# gemma3-27b: its bf16 weights alone take 59.4 GB, so the bf16 set is cut
# before its twin is cast; the same first group and local layer (PERF.md
# has the distance by depth from path_check).
PATH_LAYERS = {"zamba2-1.2b": 6, GRANITE: 1, MOONSHOT: 4, GEMMA: 7,
               GEMMA27: 7}
# models whose bf16 weights are cut to the path check's depth once served,
# and their f32 twin with them (the graph check too); every other twin is
# the full model
TWIN_CUT = (MOONSHOT, GEMMA, GEMMA27)


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
    toks = pc.prompt(cfg, "cuda", PATH_PROMPT.get(cfg.name, pc.PROMPT))
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


def layout_check(rt, cfg, params32) -> None:
    """The local_global caches on the card, in f32 (``cfg`` cut in depth):
    a 1500-token prefill and 4 decode steps (positions 1500-1503 evict
    476-479 from the rings: the wrap point moves), against the keys and
    values of the whole 1504-token sequence recomputed by one prefill
    (each layer's k/v as the attention returns them). Each local layer's
    ring must hold position p at slot p % W for the last W positions, and
    each global layer's cache every position, within F32_PATH_TOL of
    their scale (a key in the wrong slot is off by the scale itself)."""
    lm = rt.LM.from_params(cfg, params32)
    S, steps = PATH_PROMPT[cfg.name], rt.path_check.STEPS
    max_len = MODEL_MAX_LEN[cfg.name]
    toks = rt.path_check.prompt(cfg, "cuda", S)
    full, attention = [], rt.transformer.attention

    def recorded(*args, **kw):
        out, kv = attention(*args, **kw)
        full.append(kv)
        return out, kv

    with torch.inference_mode():
        _, cache = lm.prefill(toks[:, :S], max_len)
        for i in range(steps):
            lm.decode_step(toks[:, S + i], cache,
                           torch.tensor([S + i], device="cuda"))
        rt.transformer.attention = recorded
        try:
            lm.prefill(toks, max_len)
        finally:
            rt.transformer.attention = attention
    n, W = S + steps, cache["k_win"].shape[3]
    p = torch.arange(n - W, n, device="cuda")
    worst = 0.0
    for (glob, j), kv in zip(rt.lg_layers(cfg), full, strict=True):
        for name in ("k", "v"):
            if glob:
                got, want = cache[name][j][:, :, :n], kv[name]
            else:
                got, want = cache[f"{name}_win"][j][:, :, p % W], \
                    kv[name][:, :, p]
            worst = max(worst, float((got - want).abs().max())
                        / float(want.abs().max()))
    print(f"layout {cfg.name}: after a {S}-token prefill and {steps} decode "
          f"steps, {cfg.n_layers} layers' caches (rings of {W} slots: "
          f"position p at slot p % {W}, positions {n - W}-{n - 1}) against "
          f"the {n} positions recomputed in full: max |diff| {worst:.3e} of "
          f"their scale (tolerance {F32_PATH_TOL})", flush=True)
    if worst > F32_PATH_TOL:
        fail(f"layout {cfg.name}: the caches differ from the recomputed keys "
             f"by {worst:.3e} of their scale")


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
    cache_check(rt, lm, cfg)
    redecode_check(lm, cfg, done)
    step_times(rt, lm, cfg)
    serving_peak = torch.cuda.max_memory_allocated()
    del lm, done
    gc.collect()                  # the engine's graphs, pool and caches
    torch.cuda.empty_cache()
    # the f32 twin: the bf16 draw cast (exact), so no second draw; a cut
    # twin is cast from the cut bf16 set, the other layers' weights freed
    # first
    depth = PATH_LAYERS[arch] if arch in TWIN_CUT else cfg.n_layers
    _, params = rt.path_check.depth_cut(cfg, params, depth)
    gc.collect()
    torch.cuda.empty_cache()
    cfg32, params32 = rt.path_check.f32_twin(cfg, params, depth)
    graph_check(rt, cfg32, params32)
    path_check(rt, cfg, params, params32)
    if cfg.modality != "text":
        frontend_check(rt, cfg, params32)
    if rt.family_kind(cfg) == "local_global":
        layout_check(rt, cfg32, params32)
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
                       "src/repro/mc/kernels.py:112"),
           # the backward kernels: the gradients of the Pallas kernels'
           # functions (the JAX package has no backward kernel)
           "fused_rmsnorm_bwd": ("src/repro_torch/csrc/fused_rmsnorm.cu",
                                 "src/repro/kernels/fused_rmsnorm.py:19"),
           "flash_bwd_preprocess": (
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention.py:77"),
           "flash_bwd_dkdv": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                              "src/repro/kernels/flash_attention.py:77"),
           "flash_bwd_dq": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:77"),
           "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan_bwd.cu",
                            "src/repro/kernels/ssm_scan.py:49"),
           "rwkv6_scan_bwd": ("src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                              "src/repro/kernels/rwkv6_scan.py:46")}


def load_port() -> SimpleNamespace:
    """The port's entry points, imported from src/ beside this script."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs, params
    from repro_torch.kernels import build, ops, plain
    from repro_torch.kernels.common import HEAD_DIMS
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
    from repro_torch.models import transformer
    from repro_torch.models.rwkv import LORA
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.models.transformer import (family_kind, lg_layers,
                                                zamba_groups)
    from repro_torch.serving import LiveRequest, ServingEngine
    from repro_torch.serving.graphs import SlotDecoder
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import dryrun, profile
    from repro_torch.training import (SyntheticLM, init_opt_state,
                                      load_train_state, loss_and_grads,
                                      make_train_step, state_like,
                                      train_state)
    port = SimpleNamespace(
        configs=configs, init_params=params.init_params, build=build,
        HEAD_DIMS=HEAD_DIMS,
        ops=ops, plain=plain, LM=LM, MATMUL=MATMUL, family_kind=family_kind,
        transformer=transformer, lg_layers=lg_layers,
        input_embeds_for=input_embeds_for,
        path_check=path_check, mc_time=mc_time,
        zamba_groups=zamba_groups, ssm_dims=ssm_dims, LORA=LORA,
        LiveRequest=LiveRequest,
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
    vars(port).update(
        TrainConfig=TrainConfig, SyntheticLM=SyntheticLM,
        init_opt_state=init_opt_state, make_train_step=make_train_step,
        loss_and_grads=loss_and_grads, CheckpointManager=CheckpointManager,
        train_state=train_state, state_like=state_like,
        load_train_state=load_train_state, profile=profile, dryrun=dryrun,
        backward={"fused_rmsnorm_bwd": rn.fused_rmsnorm_bwd_cuda,
                  "fused_rmsnorm_plain": rn.fused_rmsnorm_plain,
                  "flash_lse": fa.flash_attention_lse_cuda,
                  "flash_lse_plain": fa.flash_lse_plain,
                  "flash_plain": fa.flash_attention_plain,
                  "flash_bwd_plain": fa.flash_attention_bwd_plain,
                  "flash_bwd_preprocess": fa.flash_bwd_preprocess_cuda,
                  "flash_bwd_preprocess_plain": fa.flash_bwd_preprocess_plain,
                  "flash_bwd_dkdv": fa.flash_bwd_dkdv_cuda,
                  "flash_bwd_dq": fa.flash_bwd_dq_cuda,
                  "ssm_plain": ss.ssm_scan_plain,
                  "ssm_bwd": ss.ssm_scan_bwd_cuda,
                  "ssm_bwd_plain": ss.ssm_scan_bwd_plain,
                  "chunk_cumsum": ss.chunk_cumsum,
                  "rwkv_plain": rs.rwkv6_scan_plain,
                  "rwkv_bwd": rs.rwkv6_scan_bwd_cuda,
                  "rwkv_bwd_plain": rs.rwkv6_scan_bwd_plain})
    port.backward["flash_grads"] = (
        lambda *a, **kw: flash_grads(port, *a, **kw))
    return port


PHASES = ("sass", "kernels", "train", "models", "mc")


def main() -> None:
    ap = argparse.ArgumentParser(description="on-card smoke run of the port")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all; a subset prints no result line)")
    phases = ap.parse_args().phases.split(",")
    if not set(phases) <= set(PHASES):
        fail(f"unknown phases {sorted(set(phases) - set(PHASES))}")
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

    if "sass" in phases:
        sass_check(lib_path, rt.HEAD_DIMS)
    rows, by_model = {}, {}
    if "kernels" in phases:
        timer = Timer()
        rows = kernel_phase(rt.kernels, timer)
        t0 = time.perf_counter()
        run_cases(backward_cases(rt), timer, rows)
        run_cases(scan_backward_cases(rt), timer, rows)
        guard_checks(rt)
        del timer
        t1 = time.perf_counter()
        meta_alloc_checks(rt)
        print(f"meta allocation checks {time.perf_counter() - t1:.1f} s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"backward kernel phase {time.perf_counter() - t0:.1f} s",
              flush=True)
    if "train" in phases:
        t0 = time.perf_counter()
        by_model[f"{TRAIN_ARCH} train"] = train_phase(rt, smi)
        train_checks(rt)
        gc.collect()
        torch.cuda.empty_cache()
        by_model[f"{GEMMA} train"] = train_phase(
            rt, smi, GEMMA, GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS)
        for arch in SCAN_TRAIN_ARCHS:       # full width and depth
            t1 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            by_model[f"{arch} train"] = train_phase(
                rt, smi, arch, rt.configs.get_config(arch).n_layers,
                SCAN_TRAIN_STEPS)
            print(f"train {arch} {time.perf_counter() - t1:.1f} s",
                  flush=True)
        print(f"train phase {time.perf_counter() - t0:.1f} s", flush=True)
    if "models" in phases:
        by_model.update({arch: model_phase(rt, arch) for arch in MODELS})
    if "mc" in phases:
        t0 = time.perf_counter()
        rows["mc_cell"] = mc_phase(rt, smi)
        print(f"mc phase {time.perf_counter() - t0:.1f} s", flush=True)
        by_model["paper grid"] = {"mc_cell": rows["mc_cell"]["launches"]}
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; total {time.perf_counter() - t_start:.1f} s", flush=True)
    if len(phases) < len(PHASES):
        print(f"phases {phases} only: no result line", flush=True)
        return

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
