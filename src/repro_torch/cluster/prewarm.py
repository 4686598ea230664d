"""Predictive container pre-warming from the trace's per-minute counts
(own copy of ``repro.cluster.prewarm``).

The container layer (``core.containers``) is purely *reactive*: a
sandbox only exists because some invocation already paid a cold start
for it, so the first wave of every per-minute burst is billed sandbox
boot. Providers know better — the Azure trace's per-minute invocation
counts are exactly the signal Shahrad et al.'s histogram policy keeps
per function — so this module turns that signal into a *provisioning
plan*: for each function and minute, place the expected steady-state
concurrency's worth of warm sandboxes ``lead_ms`` before the minute
starts, via :meth:`ContainerPool.prewarm` (which never evicts an
observed-warm container to make room for a bet, and whose idle memory
meters into the provider-side hold cost — pre-warming is a wager that
saved billed-init exceeds idle DRAM).

The plan is pure data: ``build_plan`` folds a task list into
``(t, func_id, mem_mb, n)`` rows; the :class:`Provisioner` walks them as
the fleet loop advances and routes each row to a node — the dispatcher's
consistent-hash ``owner`` when it has one (warmth placed where affinity
will route), else round-robin by function id. Everything is
deterministic given the workload.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional, Sequence

MINUTE_MS = 60_000.0


@dataclass(frozen=True)
class PrewarmConfig:
    """Provisioning-plan knobs."""

    lead_ms: float = 2_000.0     # provision this far before each minute
    min_per_min: int = 2         # ignore functions below this rate
    max_per_func: int = 8        # per-function per-minute sandbox cap
    headroom: float = 1.0        # scale on the expected concurrency
    keepalive_ms: Optional[float] = None  # None = the pool's own policy
    # Where the per-minute rate comes from: "oracle" reads the trace's
    # own counts (the historical planner, bit-identical default);
    # "ewma" forecasts minute m from minutes < m via an online EWMA
    # (costmodel.forecast) — what a real provider can actually do.
    forecast: str = "oracle"
    ewma_alpha: float = 0.5


def make_prewarm_config(config) -> PrewarmConfig:
    """Coerce ``None`` / kwargs dict / ``PrewarmConfig`` — the same
    accept-anything contract the container layer's
    ``as_container_config`` gives the other spec-shaped arguments."""
    if config is None:
        return PrewarmConfig()
    if isinstance(config, PrewarmConfig):
        return config
    if isinstance(config, dict):
        return PrewarmConfig(**config)
    raise TypeError(f"cannot build PrewarmConfig from {type(config)!r}")


def per_minute_counts(tasks) -> dict[int, dict[int, int]]:
    """func_id -> {minute -> invocation count}: the trace signal the
    planner (and a real provider's forecaster) reads."""
    counts: dict[int, dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for t in tasks:
        counts[t.func_id][int(t.arrival // MINUTE_MS)] += 1
    return {f: dict(m) for f, m in counts.items()}


def build_plan(tasks, config: Optional[PrewarmConfig] = None,
               ) -> list[tuple[float, int, int, int]]:
    """Fold a workload into provisioning rows ``(t, func_id, mem_mb, n)``
    sorted by time.

    ``n`` is the function's expected steady-state concurrency in that
    minute (count x mean service / 60 s, times ``headroom``), clamped to
    [1, ``max_per_func``] — one warm sandbox absorbs the burst front of
    a sparse function; a hot function gets enough to cover overlap.
    Minute 0 clamps to t=0: those rows sort before any arrival at the
    same instant, which is exactly when a just-in-time provisioner
    would have acted.
    """
    cfg = make_prewarm_config(config)
    svc_sum: dict[int, float] = defaultdict(float)
    svc_n: dict[int, int] = defaultdict(int)
    mem: dict[int, int] = {}
    for t in tasks:
        svc_sum[t.func_id] += t.service
        svc_n[t.func_id] += 1
        mem[t.func_id] = t.mem_mb
    rows = []
    for fid, minutes in per_minute_counts(tasks).items():
        mean_svc = svc_sum[fid] / svc_n[fid]
        for minute, count in minutes.items():
            if count < cfg.min_per_min:
                continue
            conc = count * mean_svc / MINUTE_MS * cfg.headroom
            n = max(1, min(cfg.max_per_func, math.ceil(conc)))
            t_prov = max(0.0, minute * MINUTE_MS - cfg.lead_ms)
            rows.append((t_prov, fid, mem[fid], n))
    rows.sort()
    return rows


class Provisioner:
    """Applies a plan to a live fleet as the clock passes each row.

    Placement: a dispatcher exposing ``owner(func_id, nodes)`` (the
    affinity family) decides — warmth goes where routing will look for
    it; otherwise rows spread round-robin by ``func_id`` so no single
    node's pool absorbs the whole bet. Nodes without a container pool
    are skipped (counted as ``skipped``).
    """

    def __init__(self, plan: Sequence[tuple], config: Optional[PrewarmConfig]
                 = None):
        self.plan = sorted(plan)
        self.cfg = make_prewarm_config(config)
        self._next = 0
        self.requested = 0   # sandboxes the plan asked for
        self.placed = 0      # actually admitted by pools (capacity-capped)
        self.skipped = 0     # rows with no pool to place into
        self.rows_applied = 0

    @classmethod
    def from_workload(cls, tasks, config: Optional[PrewarmConfig] = None,
                      ) -> "Provisioner":
        cfg = make_prewarm_config(config)
        if cfg.forecast != "oracle":
            from ..costmodel.forecast import make_plan
            return cls(make_plan(tasks, cfg), cfg)
        return cls(build_plan(tasks, cfg), cfg)

    def pending_at(self, t: float) -> bool:
        return self._next < len(self.plan) and self.plan[self._next][0] <= t

    def next_time(self) -> float:
        return self.plan[self._next][0] if self._next < len(self.plan) \
            else float("inf")

    def apply_due(self, t: float, nodes, dispatcher) -> int:
        """Provision every row with time <= ``t``; returns sandboxes
        placed. The fleet loop calls this before dispatching any
        arrival at ``t`` (provisioning at an instant precedes arrivals
        at it — the canonical tie rule the pool uses too)."""
        placed = 0
        owner = getattr(dispatcher, "owner", None)
        while self._next < len(self.plan) and self.plan[self._next][0] <= t:
            t_prov, fid, mem_mb, n = self.plan[self._next]
            self._next += 1
            self.rows_applied += 1
            self.requested += n
            if not nodes:
                self.skipped += 1
                continue
            if owner is not None:
                node = nodes[owner(fid, nodes)]
            else:
                node = nodes[fid % len(nodes)]
            pool = getattr(node.sched, "containers", None)
            if pool is None:
                self.skipped += 1
                continue
            # The node's clock may lag t (it is stepped per arrival);
            # provision at the later of the two so the pool never sees
            # time run backwards.
            placed += pool.prewarm(fid, mem_mb, max(t_prov, node.sched.now),
                                   n, keepalive_ms=self.cfg.keepalive_ms)
        self.placed += placed
        return placed

    def stats(self) -> dict:
        return {
            "requested": self.requested,
            "placed": self.placed,
            "skipped": self.skipped,
            "rows_applied": self.rows_applied,
            "rows_total": len(self.plan),
        }
