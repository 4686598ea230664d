"""Azure-'20-like FaaS trace synthesis (own copy of
``repro.traces.azure``: ``TraceSpec``, the duration ladder and
``synth_functions``).

The trace is synthesized to the statistics the paper uses: a duration
CDF with ~80% of invocations under 1 s and a heavy tail on a Fibonacci
ladder (fib(36..51) run times grow by the golden ratio a step), bursty
per-minute per-function counts, Azure's memory sizes, and ~12,442
invocations in the first two minutes. The same ``TraceSpec`` gives the
same functions, draw for draw, as the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PHI = (1.0 + 5.0 ** 0.5) / 2.0

# fib(36..51) calibrated durations (ms): golden-ratio ladder anchored at
# ~80 ms for N=36 (matches the paper's Xeon E5-2697v4 measurements scale).
# The paper calibrates N=36..46; we keep extra rungs for the Azure
# minutes-long tail so the overload regime (FIFO p99 response of minutes,
# Table I) is reproduced.
FIB_N = tuple(range(36, 52))
BUCKET_MS = tuple(80.0 * PHI ** i for i in range(len(FIB_N)))

# INVOCATION-weighted bucket mass: ~85% of invocations below 1 s
# (Azure Fig. 2), p90 lands on the 1,633 ms anchor after calibration,
# ~1% are minute-scale monsters that carry roughly half the CPU-seconds
# (which is exactly what makes scheduling policy choice matter).
BUCKET_WEIGHTS = (0.17, 0.16, 0.15, 0.14, 0.13, 0.10, 0.075,
                  0.030, 0.016, 0.007, 0.005, 0.005, 0.005,
                  0.004, 0.002, 0.001)

AZURE_MEMORY_MB = (128, 192, 256, 384, 512, 1024, 2048, 4096)
AZURE_MEMORY_P = (0.45, 0.15, 0.15, 0.15, 0.05, 0.03, 0.015, 0.005)


@dataclass
class TraceSpec:
    minutes: int = 2
    n_functions: int = 250
    invocations_per_min: float = 6221.0   # => ~12,442 in two minutes
    burst_sigma: float = 0.55             # lognormal per-function-minute burst
    duration_jitter: float = 0.08         # per-invocation lognormal sigma
    zipf_s: float = 1.1                   # function popularity skew
    edf_slack: float = 2.0                # deadline = arrival + slack*expected
    seed: int = 0


@dataclass
class FunctionMeta:
    func_id: int
    bucket: int                 # index into BUCKET_MS
    mem_mb: int
    rate: float                 # base invocations/min
    counts: np.ndarray = field(default=None)  # per-minute invocation counts


def _assign_buckets(pop: np.ndarray, weights) -> np.ndarray:
    """Stratified bucket assignment: functions (desc. by popularity) are
    greedily given the bucket with the largest remaining INVOCATION-mass
    deficit, so the realized invocation-weighted duration distribution
    matches ``weights`` closely (low variance across seeds)."""
    total = pop.sum()
    target = np.asarray(weights) * total
    assigned = np.zeros(len(target))
    out = np.zeros(len(pop), dtype=np.int64)
    order = np.argsort(-pop)
    for i in order:
        b = int(np.argmax(target - assigned))
        out[i] = b
        assigned[b] += pop[i]
    return out


def synth_functions(spec: TraceSpec) -> list[FunctionMeta]:
    """Function population: bucket (duration class), memory, popularity,
    and bursty per-minute invocation counts."""
    rng = np.random.default_rng(spec.seed)
    n = spec.n_functions
    mems = rng.choice(AZURE_MEMORY_MB, size=n, p=AZURE_MEMORY_P)
    # Zipf-ish popularity, normalized to the target aggregate rate.
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pop = ranks ** (-spec.zipf_s)
    rng.shuffle(pop)
    pop *= spec.invocations_per_min / pop.sum()
    buckets = _assign_buckets(pop, BUCKET_WEIGHTS)
    target = spec.invocations_per_min * spec.minutes
    lam = np.empty((n, spec.minutes))
    for i in range(n):
        burst = rng.lognormal(mean=-0.5 * spec.burst_sigma ** 2,
                              sigma=spec.burst_sigma, size=spec.minutes)
        lam[i] = np.maximum(pop[i] * burst, 0.0)
    counts = rng.poisson(lam)
    # Renormalize so the realized volume matches the paper's 12,442
    # first-two-minutes count (burst draws have high variance).
    realized = counts.sum()
    if realized > 0 and abs(realized - target) / target > 0.02:
        counts = rng.poisson(lam * (target / realized))
    funcs = []
    for i in range(n):
        funcs.append(FunctionMeta(func_id=i, bucket=int(buckets[i]),
                                  mem_mb=int(mems[i]), rate=float(pop[i]),
                                  counts=counts[i]))
    return funcs
