"""Declarative fleet chaos: kill/heal schedules driven through the run
(own copy of ``repro.cluster.chaos``).

Real FaaS fleets churn — hosts die mid-burst, capacity rejoins minutes
later, a deploy wipes a node's warm pool — and a cost claim that only
holds on a static healthy fleet is not a cost claim. This module turns
``ClusterSim.add_node`` / ``remove_node`` from manual calls into a
first-class harness: a :class:`ChaosSchedule` is a time-ordered list of
declarative events the fleet loop applies mid-run, interleaved with
arrivals at exact instants.

Semantics (DESIGN.md Sec. 14 & 17):

``kill``        -- the node vanishes at ``t``: no graceful drain. Work
                   assigned-but-unfinished there is REQUEUED through the
                   front-end dispatcher at ``t`` with its runtime state
                   reset (progress is lost; queueing is still measured
                   from the invocation's true arrival). The node's warm
                   pool is destroyed at ``t`` — its memory meter stops
                   there — and its *finished* work still counts in the
                   fleet roll-up.
``heal``        -- a fresh node (optionally with a policy ``spec``)
                   joins at ``t``: empty warm pool, clean scheduler.
                   Consistent-hash dispatchers remap ~1/N of functions.
``flush_warm``  -- the node survives but its warm pool is lost at ``t``
                   (deploy / OOM / sandbox-runtime restart): every
                   subsequent invocation there pays a cold start until
                   warmth is rebuilt.

Correlated failure domains (they require a fleet ``topology``):

``kill_zone``   -- every live node in ``zone`` dies at ``t`` (zone
                   power/network loss). One event, many victims: the
                   canonical correlated failure.
``kill_rack``   -- every live node in ``rack`` dies (PDU / ToR loss).
``revoke_spot`` -- every live *spot*-SKU node is revoked at ``t`` (the
                   provider reclaims discounted capacity; ``zone``
                   optionally scopes the revocation). The price
                   incentive and the revocation risk are one axis.
``degrade``     -- slow-not-dead: the target node (or every node in
                   ``zone``) keeps running but loses ``severity`` of
                   its clock via the engine's ``interference_fn``
                   channel — a brownout, a noisy neighbour, a thermal
                   throttle. Nothing is requeued; everything there
                   just gets slower (and costs more per invocation).
``restore``     -- the matching recovery: degraded targets return to
                   their SKU clock.

A kill's lost work is requeued immediately (the default) or routed through the
run's :class:`~repro_torch.cluster.retry.RetryPolicy` — capped exponential
backoff with deterministic jitter, a retry budget, and a per-function
circuit breaker — so a zone loss produces a bounded, priced storm.

Events name nodes by **node id** (``"node0"``), which is stable across
churn, or ``node=None`` = the first live node at fire time; correlated
events name a ``zone`` or ``rack`` label instead. An event whose target
is already gone records a no-op instead of failing: chaos schedules are
declarative wishes about a fleet that may have changed under them.

Determinism: the schedule is data, the fleet loop applies events at
exact times in (t, event-order), correlated events expand over live
nodes in fleet order, and every requeue decision flows through the same
seeded dispatcher — same seed + same schedule => bit-identical fleet
roll-ups (tested).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

ACTIONS = ("kill", "heal", "flush_warm",
           "kill_zone", "kill_rack", "revoke_spot", "degrade", "restore")

# Actions that need zone/rack/SKU labels on the fleet's nodes.
TOPOLOGY_ACTIONS = ("kill_zone", "kill_rack", "revoke_spot")


@dataclass(frozen=True)
class ChaosEvent:
    """One declarative fleet event.

    ``node`` is a node id (kill / flush_warm / degrade / restore;
    None = first live node); ``spec`` is the node policy spec a
    ``heal`` brings up (None = the fleet's default ``heal_spec``).
    ``zone``/``rack`` target failure domains (kill_zone / kill_rack;
    also accepted by degrade / restore / revoke_spot to scope them);
    ``severity`` is the clock fraction a ``degrade`` steals.
    """

    t: float
    action: str
    node: Optional[str] = None
    spec: Optional[object] = None
    zone: Optional[str] = None
    rack: Optional[str] = None
    severity: float = 0.5

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r}; have {ACTIONS}")
        if self.action == "kill_zone" and self.zone is None:
            raise ValueError("kill_zone needs zone=")
        if self.action == "kill_rack" and self.rack is None:
            raise ValueError("kill_rack needs rack=")
        if not 0.0 <= self.severity < 1.0:
            raise ValueError("severity must be in [0, 1)")


@dataclass(frozen=True)
class ChaosSchedule:
    """Time-ordered chaos events plus the default heal policy spec."""

    events: tuple = ()
    heal_spec: object = "hybrid"

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            sorted(self.events, key=lambda e: e.t)))

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)


def kill_heal(t_down: float, t_up: float, node: Optional[str] = None,
              spec: object = "hybrid") -> ChaosSchedule:
    """The canonical churn pair: ``node`` dies at ``t_down`` and an
    equivalent fresh (cold!) node joins at ``t_up``."""
    if t_up <= t_down:
        raise ValueError("heal must come after kill")
    return ChaosSchedule(events=(
        ChaosEvent(t=t_down, action="kill", node=node),
        ChaosEvent(t=t_up, action="heal", spec=spec),
    ), heal_spec=spec)


def churn_preset(horizon_ms: float, node_policy: object = "hybrid",
                 flush_node: Optional[str] = None) -> ChaosSchedule:
    """The benchmark/CI chaos preset: one mid-run node loss healed by a
    cold replacement, plus a warm-pool wipe on a surviving node — node
    churn AND cold-start-storm pressure in one schedule.

    * kill ``node0`` at 25% of the horizon (mid first burst),
    * wipe ``flush_node``'s warm pool (default ``node1``) at 45%,
    * heal with a fresh ``node_policy`` node at 60%.
    """
    return ChaosSchedule(events=(
        ChaosEvent(t=0.25 * horizon_ms, action="kill", node="node0"),
        ChaosEvent(t=0.45 * horizon_ms, action="flush_warm",
                   node=flush_node or "node1"),
        ChaosEvent(t=0.60 * horizon_ms, action="heal", spec=node_policy),
    ), heal_spec=node_policy)


def zone_failure_preset(horizon_ms: float,
                        kill: str = "z1", brownout: str = "z0",
                        node_policy: object = "hybrid",
                        severity: float = 0.5,
                        heals: int = 2) -> ChaosSchedule:
    """The correlated-failure preset the topology benchmark runs: a
    zone brownout, a full zone loss, a spot revocation sweep, partial
    recovery — every failure mode of DESIGN.md Sec. 17 in one schedule.

    * ``brownout`` zone degrades (slow-not-dead) at 15% of the horizon,
    * ``kill`` zone dies wholesale at 30% (correlated kill + storm),
    * every spot node is revoked at 50% (the price incentive bites),
    * ``heals`` fresh nodes join from 60% (one per 5% of horizon),
    * the brownout lifts at 75%.
    """
    events = [
        ChaosEvent(t=0.15 * horizon_ms, action="degrade", zone=brownout,
                   severity=severity),
        ChaosEvent(t=0.30 * horizon_ms, action="kill_zone", zone=kill),
        ChaosEvent(t=0.50 * horizon_ms, action="revoke_spot"),
    ]
    for k in range(heals):
        events.append(ChaosEvent(t=(0.60 + 0.05 * k) * horizon_ms,
                                 action="heal", spec=node_policy))
    events.append(ChaosEvent(t=0.75 * horizon_ms, action="restore",
                             zone=brownout))
    return ChaosSchedule(events=tuple(events), heal_spec=node_policy)
