"""Fleet-level metric and cost roll-ups (own copy of
``repro.cluster.metrics``).

A cluster run is judged on three axes the single-node ``SimResult``
cannot express:

* balance  — per-node utilization spread (a dispatcher that piles work
             on one node wastes the rest of the fleet);
* latency  — fleet-wide slowdown (turnaround / service) percentiles,
             which normalize across the heavy-tailed duration mix;
* money    — total $ via the same AWS Lambda model as the paper
             (``core.cost``), summed over every node; with containers
             modelled, split into the cold-start share of the user bill
             plus the provider-side warm-pool memory-hold cost.

Tasks in these roll-ups come from each node's ``completed`` list, so
their metrics are defined; ``failed`` invocations are counted
separately and never enter latency/cost vectors.

Like the single-node roll-ups, the fleet roll-ups are ORDER-CANONICAL
(DESIGN.md Sec. 13): the task view is sorted by (completion, tid) and
money sums are exactly rounded, so summaries are bit-identical under
any permutation of each node's completed list.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np

from ..core.cost import (duration_cost_usd, rejected_request_cost_usd,
                         workload_cost_usd)
from ..core.metrics import SimResult


@dataclass
class ClusterResult:
    node_results: list[SimResult]
    node_ids: list[str]
    node_policies: list[str]
    dispatcher: str
    cores_per_node: int
    assignments: list = field(default_factory=list)
    redispatches: int = 0  # straggler re-dispatches (serving fleets)
    n_retired: int = 0  # trailing node_results rows removed mid-run
    # -- resilience layers (DESIGN.md Sec. 14) ------------------------------
    shed: list = field(default_factory=list)       # front-door rejects
    chaos_events: list = field(default_factory=list)
    admission: Optional[dict] = None               # AdmissionControl.stats()
    prewarm_stats: Optional[dict] = None           # Provisioner.stats()
    # -- failure-domain topology (DESIGN.md Sec. 17) ------------------------
    # One dict per node_results row: zone/rack/SKU labels and price
    # multipliers (empty list on flat fleets — every multiplier 1.0).
    node_meta: list = field(default_factory=list)
    cross_zone: int = 0                            # out-of-zone dispatches
    retry_stats: Optional[dict] = None             # RetryState.stats()
    degraded_ms: float = 0.0                       # sum of degrade intervals
    # -- cost-model substrate (DESIGN.md Sec. 18) ---------------------------
    # Learned dispatcher state (CostAwareDispatch.snapshot(): coeff /
    # n_observed / mean_abs_err_ms), None for stateless dispatchers.
    dispatcher_state: Optional[dict] = None
    # PricingSpec the roll-ups bill with (None = DEFAULT_PRICING,
    # bit-identically). Set post-run by the Scenario layer.
    pricing: Optional[object] = None

    # -- task views (cached: summary() walks these repeatedly) --------------
    @cached_property
    def tasks(self) -> list:
        """Fleet-wide finished tasks in canonical (completion, tid)
        order — node order and per-node list order cannot leak into any
        derived metric."""
        return sorted((t for r in self.node_results for t in r.tasks
                       if t.completion is not None),
                      key=lambda t: (t.completion, t.tid))

    @cached_property
    def failed(self) -> list:
        return [t for r in self.node_results for t in r.failed]

    def execution(self) -> np.ndarray:
        return np.array([t.execution for t in self.tasks])

    def slowdown(self) -> np.ndarray:
        return np.array([t.turnaround / t.service for t in self.tasks])

    # -- balance ------------------------------------------------------------
    def makespan(self) -> float:
        # Canonical order: last wins. A fleet can finish NOTHING (chaos
        # killed every node / admission shed everything) — that is a
        # reportable outcome, not a crash.
        return self.tasks[-1].completion if self.tasks else 0.0

    @property
    def live_results(self) -> list[SimResult]:
        """Nodes still in the fleet (retired rows sort last)."""
        n = len(self.node_results) - self.n_retired
        return self.node_results[:n]

    def node_utilization(self, horizon: float = None) -> np.ndarray:
        """Busy fraction per LIVE node over the fleet makespan — a node
        removed mid-run would otherwise read as dispatcher imbalance."""
        if horizon is None:
            horizon = self.makespan()
        if horizon <= 0.0:
            return np.zeros(len(self.live_results))
        out = []
        for r in self.live_results:
            busy = math.fsum(t.cpu_time for t in r.tasks)
            out.append(busy / (self.cores_per_node * horizon))
        return np.array(out)

    def utilization_spread(self) -> dict[str, float]:
        u = self.node_utilization()
        return {"min": float(u.min()), "max": float(u.max()),
                "range": float(u.max() - u.min()), "std": float(u.std())}

    def assignment_counts(self) -> list[int]:
        """Per-node assignment totals, in ``node_results`` order.
        Assignments are keyed by node id, which survives add/remove
        churn (result rows reorder: live nodes first, retired last)."""
        pos = {nid: k for k, nid in enumerate(self.node_ids)}
        counts = [0] * len(self.node_ids)
        for _, nid in self.assignments:
            counts[pos[nid]] += 1
        return counts

    # -- latency / money ----------------------------------------------------
    def p_slowdown(self, pct: float) -> float:
        return float(np.percentile(self.slowdown(), pct))

    def _price_mults(self) -> Optional[list]:
        """Per-node effective price multipliers, or None when every node
        bills at the flat rate (the historical — and bit-identical —
        single-sum path)."""
        if not self.node_meta:
            return None
        mults = [m.get("price_mult", 1.0) for m in self.node_meta]
        return mults if any(m != 1.0 for m in mults) else None

    def cost_usd(self) -> float:
        mults = self._price_mults()
        if mults is None:
            return workload_cost_usd(self.execution(),
                                     mem_mb=[t.mem_mb for t in self.tasks],
                                     pricing=self.pricing)
        # Heterogeneous SKUs: each node's bill is priced at ITS
        # multiplier over its own (completion, tid)-sorted completions,
        # then exactly summed — still order-canonical, because node_
        # results order is the fleet's deterministic roster order.
        per_node = []
        for r, mult in zip(self.node_results, mults):
            done = sorted((t for t in r.tasks if t.completion is not None),
                          key=lambda t: (t.completion, t.tid))
            per_node.append(workload_cost_usd(
                [t.execution for t in done],
                mem_mb=[t.mem_mb for t in done], price_mult=mult,
                pricing=self.pricing))
        return math.fsum(per_node)

    def spot_savings_usd(self) -> float:
        """Money NOT billed because work landed on discounted spot
        capacity: each spot node's duration bill at its base SKU rate
        times its discount. Zero without a topology (or without spot
        nodes) — reported so the bench headline can show the price of
        chasing the discount (revocations requeue work) next to the
        discount itself."""
        if not self.node_meta:
            return 0.0
        out = []
        for r, m in zip(self.node_results, self.node_meta):
            if not m.get("spot") or not m.get("spot_discount"):
                continue
            done = sorted((t for t in r.tasks if t.completion is not None),
                          key=lambda t: (t.completion, t.tid))
            base = duration_cost_usd([t.execution for t in done],
                                     [t.mem_mb for t in done],
                                     pricing=self.pricing)
            out.append(base * m.get("base_price_mult", 1.0)
                       * m["spot_discount"])
        return math.fsum(out)

    def rejected_cost_usd(self) -> float:
        """Per-request fees incurred by admission-shed invocations —
        reported separately so shedding never masquerades as savings."""
        return rejected_request_cost_usd(len(self.shed), self.pricing)

    def total_cost_usd(self) -> float:
        """User-facing bill including rejected-request fees."""
        return self.cost_usd() + self.rejected_cost_usd()

    def requeued(self) -> int:
        """Invocations re-dispatched after a chaos kill — lost in-flight
        work plus concurrency-slot waiters stranded on dead nodes."""
        return sum(e.get("requeued", 0) + e.get("slot_requeued", 0)
                   for e in self.chaos_events)

    def revoked(self) -> int:
        """Nodes reclaimed by spot revocation events."""
        return sum(e.get("revoked", 0) for e in self.chaos_events)

    # -- container lifecycle ------------------------------------------------
    # Fleet values aggregate the per-node SimResult helpers so the
    # definitions (what counts as cold, how init is priced) live in
    # exactly one place: core.metrics.

    def cold_starts(self) -> int:
        return sum(r.cold_starts() for r in self.node_results)

    def cold_start_rate(self) -> float:
        return (self.cold_starts() / len(self.tasks)) if self.tasks else 0.0

    def init_cost_usd(self) -> float:
        """Cold-start share of the fleet's user-facing bill."""
        return sum(r.init_cost_usd() for r in self.node_results)

    def warm_hold_usd(self) -> float:
        """Provider-side warm-pool memory-hold cost, fleet-wide."""
        return sum(r.warm_hold_usd() for r in self.node_results)

    def container_stats(self) -> dict | None:
        """Fleet-wide pool counters (None when no node has a pool)."""
        per_node = [r.container_stats for r in self.node_results
                    if r.container_stats is not None]
        if not per_node:
            return None
        keys = ("warm_hits", "cold_starts", "evictions_ttl",
                "evictions_capacity", "evictions_flush", "dropped",
                "prewarmed", "warm_mb_ms", "queued_concurrency",
                "granted_from_queue")
        agg = {k: sum(s[k] for s in per_node) for k in keys}
        total = agg["warm_hits"] + agg["cold_starts"]
        agg["cold_start_rate"] = (agg["cold_starts"] / total) if total else 0.0
        return agg

    def summary(self) -> dict:
        # Compute each derived array once: this runs per sweep cell on
        # the grid-runner hot path. Empty percentile inputs (a fleet
        # that completed nothing) report as zero, not as a crash.
        slowdown = self.slowdown() if self.tasks else np.zeros(1)
        horizon = self.makespan()
        util = self.node_utilization(horizon)
        if util.size == 0:          # chaos can retire the whole fleet
            util = np.zeros(1)
        turnaround = [t.turnaround for t in self.tasks] or [0.0]
        out = {
            "dispatcher": self.dispatcher,
            "node_policies": list(dict.fromkeys(self.node_policies)),
            "n_nodes": len(self.live_results),
            "cores_per_node": self.cores_per_node,
            "n": len(self.tasks),
            "failed": len(self.failed),
            "p50_slowdown": float(np.percentile(slowdown, 50)),
            "p99_slowdown": float(np.percentile(slowdown, 99)),
            "p99_turnaround_s": float(np.percentile(turnaround, 99)) / 1e3,
            "makespan_s": horizon / 1e3,
            "util_mean": float(util.mean()),
            "util_range": float(util.max() - util.min()),
            "util_std": float(util.std()),
            "cost_usd": self.cost_usd(),
            # Container economics: zeros when the fleet runs without the
            # lifecycle layer, so downstream CSV/JSON schemas are stable.
            "cold_starts": self.cold_starts(),
            "cold_start_rate": self.cold_start_rate(),
            "init_cost_usd": self.init_cost_usd(),
            "warm_hold_usd": self.warm_hold_usd(),
            # Resilience accounting: stable zeros when the layers are
            # off, so downstream JSON/CSV schemas never fork.
            "shed": len(self.shed),
            "rejected_cost_usd": self.rejected_cost_usd(),
            "requeued": self.requeued(),
            "chaos_events": len(self.chaos_events),
            "queued": (self.admission or {}).get("queued", 0),
            "spilled": (self.admission or {}).get("spilled", 0),
            "prewarmed": (self.prewarm_stats or {}).get("placed", 0),
            # Topology / retry accounting (DESIGN.md Sec. 17): stable
            # zeros when the fleet is flat and no retry policy is set.
            "retries": (self.retry_stats or {}).get("retries", 0),
            "retry_wait_ms": (self.retry_stats or {}).get(
                "retry_wait_ms", 0.0),
            "revoked": self.revoked(),
            "degraded_ms": self.degraded_ms,
            "cross_zone": self.cross_zone,
            "spot_savings_usd": self.spot_savings_usd(),
        }
        # Learned-coefficient state (cost-model substrate): stable
        # zeros when the dispatcher carries no estimator.
        ds = self.dispatcher_state or {}
        out["cost_coeff"] = ds.get("coeff", 0.0)
        out["cost_obs"] = ds.get("n_observed", 0)
        out["cost_pred_err_ms"] = ds.get("mean_abs_err_ms", 0.0)
        if self.redispatches:
            out["redispatches"] = self.redispatches
        return out
