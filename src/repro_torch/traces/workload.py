"""Workload construction following the paper's Sec. V-B (own copy of
``repro.traces.workload``: ``Workload``, ``generate_workload``,
``P90_ANCHOR_MS`` and ``scale_load``).

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
from .azure import BUCKET_MS, FunctionMeta, TraceSpec, synth_functions

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
