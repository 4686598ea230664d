"""Workload construction following the paper's Sec. V-B (own copy of
``repro.traces.workload``).

"We assume that the function arrives at regular intervals every minute.
Then we can calculate the function interval time in that minute by
dividing 60 by the number of function invocations in that minute. After
sorting the invocations of all functions within that minute, the time
difference between adjacent invocations is the inter-arrival time."

``calibrate_p90`` then pins the sample's p90 duration to the paper's
1,633 ms anchor. The same ``TraceSpec`` gives bit-identical tasks in both
packages.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from ..core.events import Task
from .azure import BUCKET_MS, FIB_N, FunctionMeta, TraceSpec, synth_functions

P90_ANCHOR_MS = 1633.0  # paper Sec. II-E: 90th pct of the 2-min workload


@dataclass
class Workload:
    tasks: list[Task]
    spec: TraceSpec
    scale: float  # calibration factor applied to all durations

    @property
    def iats(self) -> np.ndarray:
        at = np.array([t.arrival for t in self.tasks])
        return np.diff(at)

    def p90_service(self) -> float:
        return float(np.percentile([t.service for t in self.tasks], 90))


def _invocation_times(funcs: list[FunctionMeta], minutes: int) -> list[tuple]:
    """(arrival_ms, func) pairs: regular per-minute spacing, then merged."""
    events: list[tuple[float, FunctionMeta]] = []
    for f in funcs:
        for minute in range(minutes):
            k = int(f.counts[minute])
            if k <= 0:
                continue
            interval = 60_000.0 / k
            for j in range(k):
                events.append((minute * 60_000.0 + j * interval, f))
    events.sort(key=lambda e: (e[0], e[1].func_id))
    return events


def generate_workload(spec: TraceSpec | None = None,
                      calibrate_p90: float | None = P90_ANCHOR_MS) -> Workload:
    spec = spec or TraceSpec()
    rng = np.random.default_rng(spec.seed + 1)
    funcs = synth_functions(spec)
    events = _invocation_times(funcs, spec.minutes)

    services = np.empty(len(events))
    for i, (_, f) in enumerate(events):
        jitter = rng.lognormal(mean=-0.5 * spec.duration_jitter ** 2,
                               sigma=spec.duration_jitter)
        services[i] = BUCKET_MS[f.bucket] * jitter

    scale = 1.0
    if calibrate_p90 is not None:
        scale = calibrate_p90 / float(np.percentile(services, 90))
        services *= scale

    tasks = []
    for i, (arrival, f) in enumerate(events):
        service = float(services[i])
        expected = BUCKET_MS[f.bucket] * scale
        tasks.append(Task(
            tid=i, arrival=arrival, service=service, mem_mb=f.mem_mb,
            func_id=f.func_id, bucket=f.bucket,
            deadline=arrival + spec.edf_slack * expected,
        ))
    return Workload(tasks=tasks, spec=spec, scale=scale)


def scale_load(tasks: list[Task], factor: float) -> list[Task]:
    """Compress inter-arrival times by ``factor`` (>1 = heavier load).

    Service demands are untouched — this models more users hitting the
    same function population. Tasks are copied; deadlines keep their
    slack relative to arrival.
    """
    if factor <= 0:
        raise ValueError("load factor must be positive")
    out = []
    for t in tasks:
        c = copy.copy(t)
        slack = t.deadline - t.arrival
        c.arrival = t.arrival / factor
        c.deadline = c.arrival + slack
        out.append(c)
    return out


def shard_tasks(tasks: list[Task], n_shards: int,
                by: str = "hash") -> list[list[Task]]:
    """Statically partition a workload across ``n_shards`` nodes.

    ``by='hash'`` keys on ``func_id`` (every invocation of a function
    lands in one shard — the static analogue of affinity dispatch);
    ``by='interleave'`` deals arrivals round-robin (load-balanced but
    affinity-free). Dynamic routing lives in ``repro_torch.cluster.dispatch``.
    """
    if n_shards < 1:
        raise ValueError("need at least one shard")
    shards: list[list[Task]] = [[] for _ in range(n_shards)]
    ordered = sorted(tasks, key=lambda t: (t.arrival, t.tid))
    if by == "hash":
        for t in ordered:
            shards[t.func_id % n_shards].append(t)
    elif by == "interleave":
        for i, t in enumerate(ordered):
            shards[i % n_shards].append(t)
    else:
        raise KeyError(f"unknown shard key {by!r}")
    return shards


def keepalive_hints(tasks: list[Task],
                    config: "ContainerConfig | None" = None,
                    ) -> dict[int, float]:
    """Per-function keep-alive signals for the container layer.

    For each function with >= 2 invocations, suggest holding its sandbox
    warm for ``hist_margin`` x the ``hist_pct``-th percentile of its
    observed inter-arrival times (clamped to the config's hist bounds) —
    the trace-driven analogue of the Azure histogram policy (Shahrad et
    al.). The knobs come from the SAME ``ContainerConfig`` the hints
    will feed, so pre-observation hints and the pool's own
    post-observation estimates agree. Functions seen once get no hint;
    the pool falls back to its default TTL for them. Feed the result to
    ``ContainerConfig(prewarm=...)`` (e.g. via ``dataclasses.replace``).
    """
    from ..core.containers import ContainerConfig
    cfg = config if config is not None else ContainerConfig()
    arrivals: dict[int, list[float]] = {}
    for t in sorted(tasks, key=lambda x: x.arrival):
        arrivals.setdefault(t.func_id, []).append(t.arrival)
    hints: dict[int, float] = {}
    for fid, at in arrivals.items():
        if len(at) < 2:
            continue
        iats = np.diff(np.asarray(at))
        ka = float(np.percentile(iats, cfg.hist_pct)) * cfg.hist_margin
        hints[fid] = min(max(ka, cfg.hist_min_ms), cfg.hist_max_ms)
    return hints


def workload_file(w: Workload) -> list[dict]:
    """The paper's workload-file rows: IAT + Fibonacci argument N."""
    rows = []
    prev = 0.0
    for t in w.tasks:
        rows.append({"iat_ms": t.arrival - prev, "fib_n": FIB_N[t.bucket],
                     "mem_mb": t.mem_mb, "func_id": t.func_id})
        prev = t.arrival
    return rows
