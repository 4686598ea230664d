"""The batched engine's regime gate (own copy of ``repro.mc.dispatch``,
less XLA's persistent compile cache: the port's kernels are built once
into ``build/repro_torch/``, which survives restarts).

``supported(scenario)`` returns ``None`` when a scenario sits inside the
regime the kernel reproduces bit for bit, else a :class:`Refusal`: a plain
human-readable string that also carries a stable ``key`` for fallback
accounting (``reason_key``), so sweeps can report *why* cells fell back.
Everything the gate refuses routes to the scalar engine: callers
(``cluster.sweep --backend torch``, ``MonteCarlo``) partition their cells
with this gate and never change results, only speed.

The gate is STATIC: it looks only at the specs, never at run state, so a
cell's route is decided before any work happens. In-regime means:

* single node, OR a flat multi-node fleet behind a STATE-OBLIVIOUS
  dispatcher (``round_robin`` | ``random``): those routing decisions are
  a pure function of dispatch order and ``FleetSpec.seed``, so the fleet
  decomposes into independent per-node cells batched side by side;
  state-aware dispatchers (least_loaded, affinity, ...) observe node
  heartbeats and still run through ``ClusterSim``;
* no node_factory, no heterogeneous ``nodes`` override, no topology,
* no container pool, no serving slots, no microvm/ghost models,
* no chaos / admission / pre-warm / retry resilience layers,
* policy ``fifo`` | ``cfs`` | ``hybrid`` with default knobs (a hybrid
  may override ``n_fifo`` / ``time_limit_ms`` via ``kw``: both are
  per-cell kernel inputs),
* workload kinds ``azure`` / ``synthetic`` / ``tasks`` whose built task
  list is canonical (``tasks_supported``): tids equal list indices,
  arrivals non-decreasing, no auxiliary tasks, nothing run yet.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from ..scenario import Scenario

SUPPORTED_POLICIES = ("fifo", "cfs", "hybrid")

# Fleet dispatchers whose routing is a pure function of (dispatch order,
# seed): no node state observed, so assignments replay in Python and each
# node becomes an independent batched cell.
REPLAYABLE_DISPATCHERS = ("round_robin", "random")

# Hybrid kwargs the kernel takes as per-cell inputs; anything else in
# PolicySpec.kw (adapters, custom latencies, interference) falls back.
_HYBRID_KW = {"n_fifo", "time_limit_ms"}


class Refusal(str):
    """A refusal reason: behaves as the human-readable message
    everywhere while carrying a stable ``key``."""

    key: str

    def __new__(cls, key: str, msg: str) -> "Refusal":
        self = super().__new__(cls, msg)
        self.key = key
        return self


def reason_key(why) -> str:
    """Stable counter key for a refusal (``"other"`` for plain
    strings)."""
    return getattr(why, "key", "other")


def supported(sc: "Scenario") -> Optional[Refusal]:
    """None if the batched engine reproduces ``sc`` bit for bit, else the
    reason it must run on the scalar engine."""
    fl, pol, res, wl = sc.fleet, sc.policy, sc.resilience, sc.workload
    if fl.is_fleet:
        if fl.topology is not None:
            return Refusal("topology",
                           "failure-domain topology attached")
        if fl.nodes is not None:
            return Refusal("hetero_nodes",
                           "heterogeneous per-node policy override")
        disp = fl.dispatcher if fl.dispatcher is not None \
            else "least_loaded"
        if not isinstance(disp, str):
            return Refusal("fleet_dispatcher",
                           "fleet dispatcher instance (unreplayable "
                           "state) runs through ClusterSim")
        if disp not in REPLAYABLE_DISPATCHERS:
            return Refusal(
                "fleet_dispatcher",
                f"fleet dispatcher {disp!r} is state-aware; runs "
                f"through ClusterSim")
    if fl.node_factory is not None:
        return Refusal("node_factory", "custom node_factory")
    if fl.containers is not None:
        return Refusal("containers", "container pool attached")
    if pol.serving is not None:
        return Refusal("serving", "serving slot scheduler")
    if pol.name not in SUPPORTED_POLICIES:
        return Refusal("policy", f"policy {pol.name!r} not batched")
    if pol.microvm or pol.ghost_mode:
        return Refusal("system_model",
                       "microvm/ghost system-effect model")
    if pol.adapt_pct is not None or pol.rightsize:
        return Refusal("adaptive", "adaptive time limit / rightsizer")
    if pol.n_fifo is not None:
        # The scalar engine reads n_fifo only from pol.kw on the
        # single-node path and via a policy node_factory on fleets.
        return Refusal("n_fifo",
                       "PolicySpec.n_fifo feeds node factories; the "
                       "batched path reads kw only")
    if pol.kw:
        if pol.name != "hybrid" or not set(pol.kw) <= _HYBRID_KW:
            return Refusal("kwargs",
                           f"scheduler kwargs {sorted(pol.kw)} "
                           f"not batched")
    if res.chaos is not None or res.admission is not None \
            or res.prewarm is not None or res.retry is not None:
        return Refusal("resilience",
                       "resilience layer (chaos/admission/prewarm/"
                       "retry)")
    if wl.kind not in ("azure", "synthetic", "tasks"):
        return Refusal("workload", f"workload kind {wl.kind!r} "
                                   f"not batched")
    C = fl.cores_per_node
    if pol.name == "hybrid":
        n_fifo = pol.kw.get("n_fifo", C // 2)
        if not 1 <= n_fifo < C:
            return Refusal("hybrid_split",
                           "hybrid needs 1 <= n_fifo < n_cores")
    return None


def tasks_supported(tasks) -> Optional[Refusal]:
    """None for a canonical task stream, else why it is not one (the
    dynamic half of the gate: ``kind='tasks'`` lists are caller-shaped)."""
    prev = float("-inf")
    for i, t in enumerate(tasks):
        if t.tid != i:
            return Refusal("stream_tids", "tids must equal list indices")
        if t.arrival < prev:
            return Refusal("stream_order",
                           "arrivals must be non-decreasing")
        prev = t.arrival
        if t.aux_of is not None:
            return Refusal("aux_tasks", "aux (microvm companion) tasks")
        if t.remaining != t.service:
            return Refusal("partial_tasks", "partially-run tasks")
    return None
