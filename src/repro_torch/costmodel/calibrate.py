"""Calibration: time the kernels, fit the predictor (own copy of
``repro.costmodel.calibrate``; the synthetic mode, the fit and the
artifact are the JAX package's, bit for bit, and the measure mode times
the port's own kernels on the card).

The pipeline is three pure stages, each deterministic and seedable:

1. **features** — FLOP/byte rows of the port's kernels, read from their
   wrappers on the meta device (``costmodel.features.kernel_features``),
   plus the analytic llm chunk rows. ``mode="synthetic"`` substitutes a
   frozen representative row table so calibration (and every test built
   on it) runs without a card.
2. **measure** — run each kernel case and take the median of
   ``repeats`` timings on the card (``mode="measure"``), or evaluate a
   hidden deterministic roofline with seeded multiplicative noise
   (``mode="synthetic"`` — ground truth the fit must recover, which
   gives the MAPE acceptance bound something objective to check).
3. **fit** — ridge regression of latency on ``(1, gflops, mbytes)`` via
   the 3x3 normal equations, solved in plain float64 with partial
   pivoting. Rows are weighted by ``1/measured²`` (the solve minimizes
   relative error — the MAPE the acceptance bound certifies), and
   feature weights are clipped at zero after the solve, so a fitted
   predictor is NON-NEGATIVE and MONOTONE non-decreasing in both FLOPs
   and bytes by construction.

The result is a versioned JSON artifact (``results/costmodel/``) that
:class:`~repro_torch.costmodel.model.LearnedCostModel` loads; the two
packages read each other's artifacts. Round-tripping
the artifact reproduces predictions bit-for-bit (json round-trips
Python floats losslessly).
"""
from __future__ import annotations

import json
import math
import random
from pathlib import Path
from typing import Optional, Sequence

from .features import GFLOP, MBYTE, feature_vector, llm_chunk_features

ARTIFACT_VERSION = 1
ARTIFACT_KIND = "costmodel-calibration"
DEFAULT_ARTIFACT_DIR = Path("results") / "costmodel"

# Representative per-op rows (small-shape magnitudes) for the synthetic
# mode: calibration must be runnable — and exactly reproducible — on a
# box with no card. The JAX package's table, value for value.
SYNTHETIC_ROWS = (
    {"op": "flash_attention", "flops": 8.6e6, "bytes": 5.2e5, "trips": 1},
    {"op": "decode_attention", "flops": 1.4e5, "bytes": 2.7e5, "trips": 1},
    {"op": "ssm_scan", "flops": 2.1e6, "bytes": 6.8e5, "trips": 2},
    {"op": "rwkv6_scan", "flops": 1.7e7, "bytes": 1.1e6, "trips": 4},
    {"op": "fused_rmsnorm", "flops": 4.0e5, "bytes": 5.3e5, "trips": 1},
    # Two larger synthetic points anchor the slope well away from the
    # intercept (a one-cluster design would fit noise).
    {"op": "synthetic_large_compute", "flops": 2.0e9, "bytes": 8.0e6,
     "trips": 8},
    {"op": "synthetic_large_memory", "flops": 5.0e7, "bytes": 6.4e7,
     "trips": 8},
)

# The hidden roofline the synthetic measurements come from: a fixed
# dispatch overhead plus compute at 50 GFLOP/s plus memory at 8 GB/s
# (interpret-mode-ish CPU numbers). The fit must recover this to within
# the seeded noise — that is what the MAPE bound certifies.
_SYNTH_T0_MS = 0.08
_SYNTH_MS_PER_GFLOP = 20.0
_SYNTH_MS_PER_MBYTE = 0.125


def synthetic_measure(rows: Sequence[dict], seed: int = 0,
                      noise: float = 0.03) -> list[dict]:
    """Deterministic stand-in measurements: hidden roofline times with
    seeded multiplicative noise. Returns new rows with ``measured_ms``."""
    rng = random.Random(seed)
    out = []
    for row in rows:
        base = (_SYNTH_T0_MS
                + row["flops"] / GFLOP * _SYNTH_MS_PER_GFLOP
                + row["bytes"] / MBYTE * _SYNTH_MS_PER_MBYTE)
        jitter = 1.0 + noise * (2.0 * rng.random() - 1.0)
        out.append(dict(row, measured_ms=base * jitter))
    return out


def _time_ms(fn, args, repeats: int, device) -> float:
    """Median of ``repeats`` timed calls after one warm-up call: CUDA
    events around each call on the card, synchronised after each; the
    host clock on the CPU. The median is the JAX package's (the upper of
    the two middle times for an even count)."""
    import time

    import torch

    cuda = device.type == "cuda"
    fn(*args)                       # warm the call (and build the kernel)
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(max(1, repeats)):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def measure_kernels(repeats: int = 5, small: bool = True,
                    device=None) -> list[dict]:
    """Feature rows with the median ``measured_ms`` of each kernel case.

    ``device=None`` is the card (``device.resolve_device``, which raises
    where there is none): each case must launch its kernel on every call,
    or this raises; nothing falls back to a plain version. ``"cpu"``
    times the plain versions on the host clock, for the tests only."""
    import torch

    from ..device import resolve_device
    from ..kernels import ops
    from .features import _kernel_cases, case_features

    dev = resolve_device(device)
    rows = []
    for name, builder in _kernel_cases(small, dev):
        fn, args = builder()
        row = case_features(name, fn, args)
        before = ops.launch_counts()[name]
        with torch.no_grad():
            row["measured_ms"] = _time_ms(fn, args, repeats, dev)
        launched = ops.launch_counts()[name] - before
        calls = 1 + max(1, repeats)
        want = calls if dev.type == "cuda" else 0
        if launched != want:
            raise RuntimeError(
                f"{name}: {calls} calls on {dev} launched the kernel "
                f"{launched} times, not {want}")
        rows.append(row)
    return rows


# -- the fit ----------------------------------------------------------------

def _solve3(A, b):
    """3x3 linear solve, partial pivoting, plain floats."""
    n = 3
    M = [list(A[i]) + [b[i]] for i in range(n)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(M[r][col]))
        if abs(M[piv][col]) < 1e-300:
            raise ValueError("singular normal equations — need more "
                             "distinct calibration rows")
        M[col], M[piv] = M[piv], M[col]
        for r in range(col + 1, n):
            f = M[r][col] / M[col][col]
            for c in range(col, n + 1):
                M[r][c] -= f * M[col][c]
    x = [0.0] * n
    for r in range(n - 1, -1, -1):
        x[r] = (M[r][n] - sum(M[r][c] * x[c] for c in range(r + 1, n))) \
            / M[r][r]
    return x


def fit_ridge(rows: Sequence[dict], l2: float = 1e-6) -> list[float]:
    """Ridge fit of ``measured_ms`` on ``(1, gflops, mbytes)``.

    Rows are weighted ``1/measured_ms²``, so the solve minimizes
    RELATIVE squared error — the quantity the MAPE acceptance bound
    certifies. Unweighted least squares lets the slowest op dominate
    and leaves sub-millisecond kernels misfit by multiples. Every
    weight is clipped at zero post-solve, making predictions
    non-negative and monotone non-decreasing in FLOPs and bytes."""
    if len(rows) < 3:
        raise ValueError("need >= 3 calibration rows for a 3-weight fit")
    A = [[0.0] * 3 for _ in range(3)]
    b = [0.0] * 3
    for row in rows:
        x = feature_vector(row)
        y = max(float(row["measured_ms"]), 1e-9)
        w = 1.0 / (y * y)
        for i in range(3):
            b[i] += w * x[i] * y
            for j in range(3):
                A[i][j] += w * x[i] * x[j]
    for i in range(3):
        A[i][i] += l2
    return [max(0.0, w) for w in _solve3(A, b)]


def predict_ms(weights: Sequence[float], row: dict) -> float:
    x = feature_vector(row)
    return weights[0] * x[0] + weights[1] * x[1] + weights[2] * x[2]


def mape(rows: Sequence[dict], weights: Sequence[float]) -> float:
    """Mean absolute percentage error of the fit over its own rows."""
    errs = [abs(predict_ms(weights, r) - r["measured_ms"])
            / r["measured_ms"] for r in rows if r["measured_ms"] > 0.0]
    return math.fsum(errs) / len(errs) if errs else 0.0


# -- the artifact -----------------------------------------------------------

def calibrate(mode: str = "synthetic", seed: int = 0, repeats: int = 5,
              small: bool = True, model: str = "deepseek-7b",
              seq_len: int = 4096, l2: float = 1e-6, device=None) -> dict:
    """Run the full pipeline; returns the artifact dict.

    ``mode="measure"`` times the port's kernels on ``device`` (the card
    when None; :func:`measure_kernels`); ``mode="synthetic"`` uses the
    frozen row table and the hidden roofline — fully deterministic per
    ``seed``, no card needed.
    """
    if mode == "measure":
        rows = measure_kernels(repeats=repeats, small=small, device=device)
    elif mode == "synthetic":
        rows = synthetic_measure(SYNTHETIC_ROWS, seed=seed)
    else:
        raise KeyError(f"unknown calibration mode {mode!r}")
    weights = fit_ridge(rows, l2=l2)
    for row in rows:
        row["predicted_ms"] = predict_ms(weights, row)

    # Token costs for the llm consumer. The raw fit is in *calibration
    # host* units (the synthetic roofline's, or the timed kernels'); the
    # sim prices against the ModelConfig's spec'd accelerator. So the reference
    # model's token costs are ANCHORED to its spec constants, the raw
    # predictions ride along, and LearnedCostModel transfers costs to
    # other models by the predictor's relative ratios — calibration
    # learns the shape of the cost surface, the anchor pins its scale.
    from ..configs.registry import get_config
    cfg = get_config(model)
    prefill_tokens = 1024
    llm_rows = llm_chunk_features(cfg, seq_len=seq_len,
                                  prefill_tokens=prefill_tokens)
    pre, dec = llm_rows[0], llm_rows[1]
    pred_ms_per_ktoken_prefill = predict_ms(weights, pre) \
        / (prefill_tokens / 1000.0)
    pred_ms_per_token_decode = predict_ms(weights, dec)

    # The queueing prior for cost_aware / admission: under fair-share
    # scheduling one unit of load inflates a chunk by roughly one
    # chunk service time, so the prior is the anchored billed span of a
    # representative chunk (mean of the prefill task and one default
    # 256-token decode slice — serving.llm.LLMSpec.decode_chunk_tokens).
    decode_chunk_tokens = 256
    prefill_chunk_ms = cfg.ms_per_ktoken_prefill * prefill_tokens / 1000.0
    decode_chunk_ms = cfg.ms_per_token_decode * decode_chunk_tokens
    queue_ms_per_load = (prefill_chunk_ms + decode_chunk_ms) / 2.0

    return {
        "version": ARTIFACT_VERSION,
        "kind": ARTIFACT_KIND,
        "mode": mode,
        "seed": seed,
        "features": ["const", "gflops", "mbytes"],
        "weights": list(weights),
        "rows": rows,
        "mape": mape(rows, weights),
        "queue_ms_per_load": queue_ms_per_load,
        "token_costs": {
            "model": cfg.name,
            "seq_len": seq_len,
            "prefill_tokens": prefill_tokens,
            "ms_per_ktoken_prefill": float(cfg.ms_per_ktoken_prefill),
            "ms_per_token_decode": float(cfg.ms_per_token_decode),
            "pred_ms_per_ktoken_prefill": pred_ms_per_ktoken_prefill,
            "pred_ms_per_token_decode": pred_ms_per_token_decode,
        },
        "rls": {"lambda": 0.98, "prior_weight": 25.0},
    }


def default_artifact_path(root: Optional[Path] = None) -> Path:
    root = Path(root) if root is not None else DEFAULT_ARTIFACT_DIR
    return root / f"calibration_v{ARTIFACT_VERSION}.json"


def save_artifact(artifact: dict, path: Optional[Path] = None) -> Path:
    path = Path(path) if path is not None else default_artifact_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=2, sort_keys=True))
    return path


def load_artifact(path) -> dict:
    artifact = json.loads(Path(path).read_text())
    if artifact.get("kind") != ARTIFACT_KIND:
        raise ValueError(f"{path}: not a {ARTIFACT_KIND} artifact")
    if artifact.get("version") != ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact version {artifact.get('version')!r} != "
            f"supported {ARTIFACT_VERSION}")
    return artifact
