"""Result aggregation: the paper's three metrics + CDFs + p99 + cost (own
copy of ``repro.core.metrics``, plus the batched engine's ``mc_stats``).

Failed invocations (admission rejects, injected faults) never ran to
completion, so their OSTEP metrics are undefined — ``Task`` properties
return NaN for them and every vector here is computed over *finished*
tasks only, with the failure count reported separately. With the
container layer attached, the summary additionally reports cold-start
counts, the billed-init share of the bill, and the provider-side cost of
holding the warm pool.

Every roll-up here is ORDER-CANONICAL (DESIGN.md Sec. 13): finished
tasks are viewed in (completion, tid) order regardless of how the list
was assembled, and cost sums are exactly rounded (``math.fsum``), so
summaries are bit-identical under any permutation of ``tasks``. This is
what lets the engine retire completions in batches: the completed list
is no longer required to be in heap-processing order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np

from .cost import (cold_start_cost_usd, cost_ladder, warm_pool_hold_cost_usd,
                   workload_cost_usd)
from .events import GROUP_CFS, GROUP_FIFO, Scheduler, Task


@dataclass
class SimResult:
    policy: str
    tasks: list[Task]
    failed: list[Task] = field(default_factory=list)
    preempt_per_core: Optional[list[int]] = None
    util_series: Optional[list] = None
    limit_series: Optional[list] = None
    migrations: Optional[list] = None
    total_ctx: int = 0
    container_stats: Optional[dict] = None
    # PricingSpec the roll-ups bill with (None = DEFAULT_PRICING,
    # bit-identically). Set post-run by the Scenario layer.
    pricing: Optional[object] = None
    # The batched engine's counts for the cell: ``iters`` (its own loop
    # trips) and ``events`` (scheduling events). Never part of summary().
    mc_stats: Optional[dict] = None

    # -- task views ---------------------------------------------------------
    @cached_property
    def _finished(self) -> list[Task]:
        return sorted((t for t in self.tasks if t.completion is not None),
                      key=lambda t: (t.completion, t.tid))

    def finished_tasks(self) -> list[Task]:
        """Tasks with defined metrics, in CANONICAL (completion, tid)
        order — every derived vector/percentile/sum is therefore
        invariant under permutations of ``self.tasks``. Roll-ups skip
        the rest (failed invocations that never completed end up in
        ``failed``, but be defensive against callers who merge the
        lists). Cached: ``summary()`` walks this ~8 times per sweep
        cell."""
        return self._finished

    # -- metric vectors (ms) ------------------------------------------------
    def execution(self) -> np.ndarray:
        return np.array([t.execution for t in self.finished_tasks()])

    def response(self) -> np.ndarray:
        return np.array([t.response for t in self.finished_tasks()])

    def turnaround(self) -> np.ndarray:
        return np.array([t.turnaround for t in self.finished_tasks()])

    def service(self) -> np.ndarray:
        return np.array([t.service for t in self.finished_tasks()])

    def p(self, metric: str, pct: float) -> float:
        return float(np.percentile(getattr(self, metric)(), pct))

    def p99(self) -> dict[str, float]:
        return {m: self.p(m, 99) / 1000.0  # seconds, as in Table I
                for m in ("response", "execution", "turnaround")}

    def makespan(self) -> float:
        # finished_tasks is sorted by (completion, tid): last wins.
        return self.finished_tasks()[-1].completion

    def total_preemptions(self) -> int:
        return sum(t.preemptions for t in self.tasks)

    # -- container lifecycle ------------------------------------------------
    def cold_starts(self) -> int:
        return sum(1 for t in self.finished_tasks() if t.cold_start)

    def cold_start_rate(self) -> float:
        done = self.finished_tasks()
        return (self.cold_starts() / len(done)) if done else 0.0

    def init_cost_usd(self) -> float:
        """The cold-start share of the user-facing bill (fsum over the
        canonical task order: permutation-invariant)."""
        return math.fsum(
            cold_start_cost_usd(t.init_ms, t.mem_mb, self.pricing)
            for t in self.finished_tasks() if t.cold_start)

    def warm_hold_usd(self) -> float:
        """Provider-side cost of the idle warm set over the run."""
        if not self.container_stats:
            return 0.0
        return warm_pool_hold_cost_usd(self.container_stats["warm_mb_ms"],
                                       self.pricing)

    # -- cost ---------------------------------------------------------------
    def cost_usd(self, fixed_mem_mb: Optional[float] = None) -> float:
        done = self.finished_tasks()
        if fixed_mem_mb is not None:
            return workload_cost_usd((t.execution for t in done),
                                     fixed_mem_mb=fixed_mem_mb,
                                     pricing=self.pricing)
        return workload_cost_usd((t.execution for t in done),
                                 mem_mb=[t.mem_mb for t in done],
                                 pricing=self.pricing)

    def cost_ladder(self) -> dict[int, float]:
        return cost_ladder(self.execution(), pricing=self.pricing)

    # -- CDF helper -----------------------------------------------------------
    def cdf(self, metric: str) -> tuple[np.ndarray, np.ndarray]:
        vals = np.sort(getattr(self, metric)())
        frac = np.arange(1, len(vals) + 1) / len(vals)
        return vals, frac

    def summary(self) -> dict:
        e, r, ta = self.execution(), self.response(), self.turnaround()
        out = {
            "policy": self.policy,
            "n": len(self.finished_tasks()),
            "failed": len(self.failed),
            "mean_execution_s": float(e.mean()) / 1e3,
            "p50_execution_s": float(np.percentile(e, 50)) / 1e3,
            "p99_execution_s": float(np.percentile(e, 99)) / 1e3,
            "p99_response_s": float(np.percentile(r, 99)) / 1e3,
            "p99_turnaround_s": float(np.percentile(ta, 99)) / 1e3,
            "makespan_s": self.makespan() / 1e3,
            "preemptions": self.total_preemptions(),
            "ctx_switches": self.total_ctx,
            "cost_usd": self.cost_usd(),
        }
        if self.container_stats is not None:
            out["cold_starts"] = self.cold_starts()
            out["cold_start_rate"] = self.cold_start_rate()
            out["init_cost_usd"] = self.init_cost_usd()
            out["warm_hold_usd"] = self.warm_hold_usd()
        return out


def collect(sched: Scheduler, policy: str) -> SimResult:
    limit_series = None
    migrations = None
    adapter = getattr(sched, "adapter", None)
    if adapter is not None:
        adapter.flush()  # apply any still-buffered completion samples
        limit_series = adapter.series
    rs = getattr(sched, "rightsizer", None)
    if rs is not None:
        migrations = rs.migrations
    container_stats = None
    pool = getattr(sched, "containers", None)
    if pool is not None:
        pool.settle(sched.now)  # bring the memory-hold meter current
        container_stats = pool.stats()
    return SimResult(
        policy=policy,
        tasks=sched.completed,
        failed=sched.failed,
        preempt_per_core=[c.preempt_count for c in sched.cores],
        util_series=sched.util_series,
        limit_series=limit_series,
        migrations=migrations,
        total_ctx=sched.total_ctx,
        container_stats=container_stats,
    )
