"""The scheduling regime's arithmetic and the task record (own copy of
``repro.core.events``: ``_EPS``, the five pure regime helpers and
``Task``).

The helpers are the only places the simulator's float recipes live, so
the scalar engine, the batched engine's plain version and its CUDA kernel
execute the SAME operation sequences. Each takes ``_min``/``_max``, which
the plain version binds to ``torch.minimum``/``torch.maximum``; on non-NaN
operands those give Python's ``min``/``max`` bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

_EPS = 1e-9


def chunk_run_ms(remaining, limit=None, *, _min=min, _max=max):
    """Chunk length granted to a task: remaining work clamped to the
    policy limit, floored at ``_EPS`` so a chunk always advances time."""
    run = remaining if limit is None else _min(remaining, limit)
    return _max(run, _EPS)


def chunk_end_ms(t, ctx, run):
    """Expiry instant of a chunk started at ``t``: left-associated
    ``(t + ctx) + run``."""
    return (t + ctx) + run


def cfs_slice_ms(nr_running, sched_latency_ms, min_granularity_ms,
                 *, _max=max):
    """CFS timeslice: target latency split over the runnable count
    (post-pick, so a lone task sees the full latency), floored at the
    minimum granularity."""
    return _max(sched_latency_ms / _max(1, nr_running),
                min_granularity_ms)


def fifo_budget_ms(limit_ms, cpu_time_ms, *, _max=max):
    """Hybrid FIFO-group budget: time limit minus CPU already consumed,
    floored at 0.01 ms so an over-budget task still runs one tick
    before migrating."""
    return _max(limit_ms - cpu_time_ms, 0.01)


def chunk_completes(remaining, run):
    """Completion predicate for a chunk of length ``run``: the
    subtraction first, then the ``_EPS`` compare."""
    return (remaining - run) <= _EPS


@dataclass(slots=True)
class Task:
    """One serverless function invocation.

    ``service`` is the pure CPU demand in ms. Metrics follow OSTEP (the
    paper's Sec. II-B):

    execution  = completion - first_run
    response   = first_run - arrival
    turnaround = completion - arrival

    Metric properties return NaN for a task that never ran or never
    finished.
    """

    tid: int
    arrival: float
    service: float
    mem_mb: int = 256
    func_id: int = 0
    bucket: int = 0

    # -- runtime state ------------------------------------------------
    remaining: float = field(default=0.0, repr=False)
    cpu_time: float = 0.0
    first_run: Optional[float] = None
    completion: Optional[float] = None
    vruntime: float = 0.0
    deadline: float = float("inf")
    preemptions: int = 0
    migrations: int = 0
    ctx_switches: int = 0
    failed: bool = False
    retries: int = 0
    aux_of: Optional[int] = None
    cold_start: bool = False
    init_ms: float = 0.0

    def __post_init__(self) -> None:
        self.remaining = self.service

    # -- metrics ------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self.completion is not None

    @property
    def execution(self) -> float:
        if self.completion is None or self.first_run is None:
            return float("nan")
        return self.completion - self.first_run

    @property
    def response(self) -> float:
        if self.first_run is None:
            return float("nan")
        return self.first_run - self.arrival

    @property
    def turnaround(self) -> float:
        if self.completion is None:
            return float("nan")
        return self.completion - self.arrival
