"""Online per-function rate forecasting for predictive pre-warming (own
copy of ``repro.costmodel.forecast``).

The oracle planner (``cluster.prewarm.build_plan``) reads the trace's
OWN per-minute counts — it knows minute *m*'s burst before it happens.
A real provider forecasts: :func:`build_forecast_plan` walks the
minutes in order and provisions minute *m* from an EWMA over the counts
of minutes strictly before it (``costmodel.online.EwmaRate``). The
first minute a function ever fires is therefore always a cold burst —
exactly the regret a forecaster pays and an oracle hides — and the plan
remains fully deterministic: the forecast is plain arithmetic over the
observed history, with no RNG anywhere.

Row shape, clamping, lead time and sorting are IDENTICAL to the oracle
planner, so the two plans differ only in where the expected
concurrency number comes from.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Optional

from .online import EwmaRate

MINUTE_MS = 60_000.0


def build_forecast_plan(tasks, config=None, alpha: float = 0.5,
                        ) -> list:
    """Fold a workload into provisioning rows ``(t, func_id, mem_mb,
    n)`` using only PAST per-minute counts per function.

    Minute 0 has no history, so nothing is provisioned for it; each
    observed minute updates the function's EWMA, and every minute after
    a function's first observation gets a row when the smoothed rate
    clears ``min_per_min`` (same threshold and clamps as the oracle).
    """
    from ..cluster.prewarm import make_prewarm_config, per_minute_counts

    cfg = make_prewarm_config(config)
    svc_sum: dict[int, float] = defaultdict(float)
    svc_n: dict[int, int] = defaultdict(int)
    mem: dict[int, int] = {}
    for t in tasks:
        svc_sum[t.func_id] += t.service
        svc_n[t.func_id] += 1
        mem[t.func_id] = t.mem_mb
    counts = per_minute_counts(tasks)
    if not counts:
        return []
    last_minute = max(m for minutes in counts.values() for m in minutes)
    rows = []
    est: dict[int, EwmaRate] = {}
    for fid in sorted(counts):
        mean_svc = svc_sum[fid] / svc_n[fid]
        fc = est.setdefault(fid, EwmaRate(alpha))
        minutes = counts[fid]
        seen = False
        for minute in range(0, last_minute + 1):
            if seen:
                pred = fc.forecast(fid)
                if pred >= cfg.min_per_min:
                    conc = pred * mean_svc / MINUTE_MS * cfg.headroom
                    n = max(1, min(cfg.max_per_func, math.ceil(conc)))
                    t_prov = max(0.0, minute * MINUTE_MS - cfg.lead_ms)
                    rows.append((t_prov, fid, mem[fid], n))
            observed = minutes.get(minute, 0)
            if observed or seen:
                # A gap minute counts as zero once the function has
                # history — silence is evidence the rate fell.
                fc.update(fid, observed)
                seen = seen or bool(observed)
    rows.sort()
    return rows


def make_plan(tasks, config=None) -> Optional[list]:
    """Dispatch on ``PrewarmConfig.forecast``: ``"oracle"`` is the
    historical trace-reading planner (bit-identical default),
    ``"ewma"`` the online forecaster."""
    from ..cluster.prewarm import build_plan, make_prewarm_config

    cfg = make_prewarm_config(config)
    mode = getattr(cfg, "forecast", "oracle")
    if mode == "oracle":
        return build_plan(tasks, cfg)
    if mode == "ewma":
        return build_forecast_plan(tasks, cfg,
                                   alpha=getattr(cfg, "ewma_alpha", 0.5))
    raise KeyError(f"unknown prewarm forecast mode {mode!r}")
