#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX
package. In order it:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the port's CUDA kernels from src/repro_torch/csrc into
   build/repro_torch/ (timed as set-up);
3. holds each kernel against its plain PyTorch version in bf16 at the
   shapes the serving path gives it, and times kernel, plain version,
   one PyTorch library call computing the same function, and the bound
   (the larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s);
4. serves 8 ragged requests through ServingEngine on full-width
   deepseek-7b (30 layers, d_model 4096, random weights from a seed),
   with the launch counts set to 0 just before and read just after;
5. times one prefill and one decode step of that model;
6. holds the kernel path against the plain path on the card (prefill
   plus 4 teacher-forced decode steps), in f32 and in bf16;
7. prints a JSON line of the kernels, then the result line.

Any failed check exits non-zero. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2                     # bf16 kernel vs plain: |a - b| <= TOL * (1 + |b|)
F32_PATH_TOL = 1e-3            # f32 logits: max |kernel - plain| / max |plain|
PATH_TOL = 2e-2                # least bf16 path tolerance (see path_check)
SEED = 0
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> tuple[float, bool]:
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool((diff <= TOL * (1.0 + ref.abs())).all()) and \
        bool(out.isfinite().all())
    return float(diff.max()), ok


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_cases(kp):
    """(kernel name, case label, kernel call, plain call, library call,
    bytes, flops) at the serving path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)

    d, BH, hd, S = 4096, 32, 128, 1024
    for n in (1, 32, 77, 200, 513, 600):
        x, w = randn(n, d), randn(d, dtype=torch.float32, scale=0.1)
        w1 = (1.0 + w).to(bf)
        yield ("fused_rmsnorm", f"x ({n}, {d})",
               lambda x=x, w=w: kp["fused_rmsnorm"][0](x, w),
               lambda x=x, w=w: kp["fused_rmsnorm"][1](x, w),
               lambda x=x, w1=w1: F.rms_norm(x, (d,), w1, eps=1e-6),
               2 * n * d * 2 + d * 4, 4 * n * d)
    for s in (1, 77, 200, 513, 600):
        q, k, v = randn(BH, s, hd), randn(BH, s, hd), randn(BH, s, hd)
        pairs = s * (s + 1) // 2
        yield ("flash_attention", f"BH {BH}, Sq = Sk = {s}, hd {hd}, causal",
               lambda q=q, k=k, v=v: kp["flash_attention"][0](q, k, v),
               lambda q=q, k=k, v=v: kp["flash_attention"][1](q, k, v),
               lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                   q[None], k[None], v[None], is_causal=True)[0],
               4 * BH * s * hd * 2, 4 * hd * pairs * BH)
    for label, lens in (("1", [1] * BH), ("77", [77] * BH),
                        ("600", [600] * BH), ("1024", [S] * BH),
                        ("mixed 1..1024", [1, 77, 1024, 513] * (BH // 4))):
        q, k, v = randn(BH, 1, hd), randn(BH, S, hd), randn(BH, S, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, :]
                < lengths[:, None])[None, :, None, :]
        yield ("decode_attention", f"BH {BH}, cache {S}, lengths {label}",
               lambda q=q, k=k, v=v, l=lengths: kp["decode_attention"][0](
                   q, k, v, l),
               lambda q=q, k=k, v=v, l=lengths: kp["decode_attention"][1](
                   q, k, v, l),
               lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                   q[None], k[None], v[None], attn_mask=m)[0],
               2 * sum(lens) * hd * 2 + 2 * BH * hd * 2 + 4 * BH,
               4 * hd * sum(lens))


def kernel_phase(kp, timer) -> dict:
    rows = {}
    for name, label, kern, plain_fn, lib, nbytes, flops in \
            kernel_cases(kp):
        out = kern()
        torch.cuda.synchronize()
        err, ok = max_err(out, plain_fn())
        lib_err, _ = max_err(lib(), plain_fn())
        if not ok:
            fail(f"{name} [{label}]: kernel disagrees with its plain "
                 f"version, max |diff| {err:.3e} (tolerance {TOL} * (1 + "
                 f"|plain|))")
        ms, plain_ms, lib_ms = timer(kern), timer(plain_fn), timer(lib)
        b_ms, b_by = bound(nbytes, flops)
        print(f"kernel {name} [{label}]: max_abs_err {err:.3e} (library "
              f"{lib_err:.3e}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {b_ms:.5f} ({b_by}) "
              f"bound/ms {b_ms / ms:.3f}", flush=True)
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        # the JSON line reports the case with the most work
        if b_ms >= row.get("bound_ms", -1.0):
            row.update(case=label, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    return rows


# -- phase 4-6: the serving path ----------------------------------------------

PROMPT_LENS = (32, 600, 77, 513, 200, 45, 333, 128)


def serving_phase(rt, cfg, params) -> dict:
    eng = rt.ServingEngine(cfg, params, n_slots=4, n_fifo=2, max_len=1024,
                           initial_limit_ms=40.0, device="cuda")
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
    print(f"serving: {n_prefill} prefills, {n_decode} decode steps in "
          f"{wall:.3f} s wall; launches {counts}", flush=True)
    if len(done) != n_prefill:
        fail(f"{len(done)} of {n_prefill} requests completed")
    for r in done:
        if len(r.generated) != 4 + 2 * r.rid:
            fail(f"request {r.rid}: {len(r.generated)} tokens, expected "
                 f"{4 + 2 * r.rid}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            fail(f"request {r.rid}: token out of range")
    if sum(r.preemptions for r in done) < 1:
        fail("no request was preempted")
    L = cfg.n_layers
    expect = {"fused_rmsnorm": (2 * L + 1) * (n_prefill + n_decode),
              "flash_attention": L * n_prefill,
              "decode_attention": L * n_decode}
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
        if n != expect[name]:
            fail(f"kernel {name}: {n} launches, the path makes {expect[name]}")
    return counts


def step_times(lm, cfg) -> None:
    """Host-clock time of one prefill and of one decode step, each ending
    in a device synchronise. The device's busy and idle share within them
    is read by ``python -m repro_torch.launch.profile``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (1, 513), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = lm.prefill(toks, 1024)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        tok = toks[:, -1]
        pos = torch.tensor([513], device="cuda")
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.decode_step(tok, cache, pos)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    weight_bytes = sum(p.numel() * p.element_size() for n, p in
                       lm.named_parameters() if n != "embed")
    print(f"step: prefill 513 tokens {prefill_s * 1e3:.2f} ms wall; decode "
          f"step (cache 514) {wall_ms:.3f} ms wall (median of 10); "
          f"weight-read bound of a decode step "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms", flush=True)


def _path_logits(rt, cfg, params, kernels, toks) -> list:
    """Prefill of 200 tokens + 4 teacher-forced decode steps."""
    lm = rt.LM.from_params(cfg, params, kernels=kernels)
    with torch.inference_mode():
        logits, cache = lm.prefill(toks[:, :200], 256)
        out = [logits.float()]
        for i in range(4):
            pos = torch.tensor([200 + i], device="cuda")
            logits, cache = lm.decode_step(toks[:, 200 + i], cache, pos)
            out.append(logits.float())
    return out


def path_check(rt, cfg, params16) -> None:
    """The serving path through the kernels against the same path through
    the plain versions, on the card, on the same weights.

    f32: the kernels' arithmetic alone; both paths round at 2^-24, so
    they must agree to F32_PATH_TOL of the logits' scale.
    bf16: the random weights inherit materialize's fan_in = layer-count
    rule (every projection multiplies the scale by ~12), so 30 layers
    amplify bf16 rounding (2^-9) far beyond 2e-2. The bound is the noise
    floor measured here: the bf16 kernel path may be at most twice as
    far from the f32 result as the bf16 plain path is (and PATH_TOL of
    the scale in any case)."""
    params32 = rt.init_params(cfg, seed=SEED, device="cuda",
                              dtype=torch.float32)
    w16, w32 = params16["layers.0.attn.wq"], params32["layers.0.attn.wq"]
    if not torch.equal(w16, w32.to(w16.dtype)):
        fail("path check: f32 and bf16 parameters are not the same draw")
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 204))).cuda()
    k16 = _path_logits(rt, cfg, params16, rt.ops, toks)
    p16 = _path_logits(rt, cfg, params16, rt.plain, toks)
    k32 = _path_logits(rt, cfg, params32, rt.ops, toks)
    p32 = _path_logits(rt, cfg, params32, rt.plain, toks)
    del params32
    for i in range(len(p32)):
        for name, t in (("k16", k16[i]), ("p16", p16[i]), ("k32", k32[i])):
            if tuple(t.shape) != (1, 1, cfg.vocab) or \
                    not bool(t.isfinite().all()):
                fail(f"path check step {i}: {name} logits "
                     f"{tuple(t.shape)} not finite or misshaped")
        scale = float(p32[i].abs().max())
        f32_rel = float((k32[i] - p32[i]).abs().max()) / scale
        k16_rel = float((k16[i] - p32[i]).abs().max()) / scale
        p16_rel = float((p16[i] - p32[i]).abs().max()) / scale
        kp16_rel = float((k16[i] - p16[i]).abs().max()) / scale
        bf16_tol = max(PATH_TOL, 2.0 * p16_rel)
        print(f"path check step {i}: f32 |kernel - plain| {f32_rel:.3e} "
              f"(tolerance {F32_PATH_TOL}); bf16 |kernel - f32| "
              f"{k16_rel:.3e}, |plain - f32| {p16_rel:.3e}, |kernel - "
              f"plain| {kp16_rel:.3e} (tolerance {bf16_tol:.3e}); argmax "
              f"kernel/plain/f32 {int(k16[i].argmax())}/"
              f"{int(p16[i].argmax())}/{int(p32[i].argmax())} "
              f"(of max |logit| {scale:.3f})", flush=True)
        if f32_rel > F32_PATH_TOL:
            fail(f"path check step {i}: f32 kernel path differs from the "
                 f"plain path by {f32_rel:.3e} of the logits' scale")
        if k16_rel > bf16_tol:
            fail(f"path check step {i}: bf16 kernel path is {k16_rel:.3e} "
                 f"from f32, beyond {bf16_tol:.3e}")


# -----------------------------------------------------------------------------

SOURCES = {"fused_rmsnorm": ("src/repro_torch/csrc/fused_rmsnorm.cu",
                             "src/repro/kernels/fused_rmsnorm.py:19"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:77"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:57")}


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
    from repro_torch.models import LM
    from repro_torch.serving import LiveRequest, ServingEngine
    return SimpleNamespace(
        configs=configs, init_params=params.init_params, build=build,
        ops=ops, plain=plain, LM=LM, LiveRequest=LiveRequest,
        ServingEngine=ServingEngine,
        kernels={"fused_rmsnorm": (rn.fused_rmsnorm_cuda,
                                   rn.fused_rmsnorm_plain),
                 "flash_attention": (fa.flash_attention_cuda,
                                     fa.flash_attention_plain),
                 "decode_attention": (da.decode_attention_cuda,
                                      da.decode_attention_plain)})


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

    rows = kernel_phase(rt.kernels, Timer())

    cfg = rt.configs.get_config("deepseek-7b")
    t0 = time.perf_counter()
    params = rt.init_params(cfg, seed=SEED, device="cuda",
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
    print(f"model: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{n_params / 1e9:.3f} B parameters, {gb:.2f} GB on the card, "
          f"initialised in {time.perf_counter() - t0:.1f} s", flush=True)

    counts = serving_phase(rt, cfg, params)
    step_times(rt.LM.from_params(cfg, params), cfg)
    path_check(rt, cfg, params)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "tolerance": TOL,
            "case": r["case"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
