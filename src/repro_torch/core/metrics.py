"""Result aggregation: the paper's three metrics, p99 and cost (own copy
of ``repro.core.metrics.SimResult`` without the container roll-ups: no
cell the port simulates has a container pool).

Every roll-up is order-canonical: finished tasks are viewed in
(completion, tid) order however the list was assembled, and cost sums
are exactly rounded, so a summary is bit-identical under any permutation
of ``tasks``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np

from .cost import cost_ladder, workload_cost_usd
from .events import Task


@dataclass
class SimResult:
    policy: str
    tasks: list[Task]
    failed: list[Task] = field(default_factory=list)
    total_ctx: int = 0
    # PricingSpec the roll-ups bill with (None = DEFAULT_PRICING).
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
        """Tasks with defined metrics, in canonical (completion, tid)
        order."""
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
        return self.finished_tasks()[-1].completion

    def total_preemptions(self) -> int:
        return sum(t.preemptions for t in self.tasks)

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

    def cdf(self, metric: str) -> tuple[np.ndarray, np.ndarray]:
        vals = np.sort(getattr(self, metric)())
        frac = np.arange(1, len(vals) + 1) / len(vals)
        return vals, frac

    def summary(self) -> dict:
        e, r, ta = self.execution(), self.response(), self.turnaround()
        return {
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
