"""Cluster front-end dispatch policies (own copy of
``repro.cluster.dispatch``).

The node-level FIFO+CFS hybrid only sees the invocations the cluster
dispatcher hands it, so the routing layer bounds how much money the
per-node scheduler can save. Eight policies spanning the design space of
the related work:

random            -- seeded uniform choice (the strawman baseline).
round_robin       -- cyclic assignment, oblivious to node state.
least_loaded      -- route to the node with the fewest admitted-but-
                     unfinished tasks per core (power-of-d with d = N).
join_idle_queue   -- pull-based dispatch a la Hiku: nodes advertise
                     idleness; an invocation goes to the idle node that
                     has waited longest, falling back to least-loaded
                     when the idle queue is empty.
affinity          -- consistent-hash function affinity a la Kaffes et
                     al.: invocations of one function land on one node
                     (warm containers, code locality), with a
                     virtual-node ring so node add/remove only remaps
                     ~1/N of functions.
warm_affinity     -- affinity that routes on the ACTUAL warm set from
                     node heartbeats: any node already holding a warm
                     sandbox for the function wins; otherwise the ring
                     owner, spilling to least-loaded past a load bound.
least_loaded_warm -- least-loaded with warm tie-breaking: among nodes
                     within a load slack of the minimum, prefer one with
                     a warm sandbox for the function.
cost_aware        -- prices each route in dollars: expected cold-start
                     penalty x the function's per-ms price, plus a
                     queueing term converting node load into billed-ms
                     (contention inflates wall-clock execution under
                     CFS). Routes to the cheapest node. The load-to-
                     billed-ms coefficient is LEARNED online from
                     completion feedback (recursive least squares with
                     forgetting; the configured constant is the prior).

All policies are deterministic under a fixed seed. ``select`` sees the
live node handles and the cluster clock; node state is whatever the
scheduler's ``load_snapshot`` reports at that instant — including the
warm-set contents when the container lifecycle layer is attached.
"""
from __future__ import annotations

import bisect
import hashlib
import random
from collections import OrderedDict
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .sim import ClusterNode

from ..core.containers import expected_cold_ms
from ..core.cost import price_per_ms
from ..core.events import Task
from ..costmodel.online import ScalarRLS


class Dispatcher:
    name = "base"
    # Learning dispatchers set this; the fleet loop then feeds every
    # completion back via observe_completion (in canonical
    # (completion, tid) order, so feedback never depends on node order).
    wants_feedback = False
    # Failure-domain topology, attached by the fleet when one exists.
    topology = None

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)

    def select(self, task: Task, nodes: Sequence["ClusterNode"],
               t: float) -> int:
        """Return the index into ``nodes`` this task is routed to."""
        raise NotImplementedError

    def on_topology_change(self, nodes: Sequence["ClusterNode"]) -> None:
        """Called when nodes join or leave the fleet."""

    def attach_topology(self, topology) -> None:
        """Called once, before the first ``on_topology_change``, when
        the fleet carries a failure-domain topology. Base dispatchers
        ignore it; ``cost_aware`` prices SKU multipliers and cross-zone
        hops with it."""
        self.topology = topology

    def observe_completion(self, task: Task) -> None:
        """Completion feedback hook (only called when wants_feedback)."""


class RandomDispatch(Dispatcher):
    name = "random"

    def select(self, task, nodes, t):
        return self.rng.randrange(len(nodes))


class RoundRobinDispatch(Dispatcher):
    name = "round_robin"

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self._next = 0

    def select(self, task, nodes, t):
        i = self._next % len(nodes)
        self._next += 1
        return i


class LeastLoadedDispatch(Dispatcher):
    name = "least_loaded"

    def select(self, task, nodes, t):
        return min(range(len(nodes)),
                   key=lambda i: (nodes[i].snapshot()["load"], i))


class JoinIdleQueueDispatch(Dispatcher):
    """Pull-based: an ordered set of idle node ids, longest-idle first.

    A real Hiku-style worker pulls work when it idles; in the
    simulation the equivalent information arrives with the snapshot we
    take at each dispatch decision, so the idle queue is refreshed then.
    """

    name = "join_idle_queue"

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self._idle: OrderedDict[int, None] = OrderedDict()

    def select(self, task, nodes, t):
        snaps = [n.snapshot() for n in nodes]
        for i, s in enumerate(snaps):
            if s["idle"]:
                if i not in self._idle:
                    self._idle[i] = None
            else:
                self._idle.pop(i, None)
        if self._idle:
            i, _ = self._idle.popitem(last=False)
            return i
        return min(range(len(nodes)), key=lambda i: (snaps[i]["load"], i))

    def on_topology_change(self, nodes):
        self._idle.clear()


def _hash64(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(),
                                          digest_size=8).digest(), "big")


class AffinityDispatch(Dispatcher):
    """Consistent-hash ring over (node id, virtual replica) points keyed
    by ``func_id``: the per-function-invocation affinity scheduler of
    Kaffes et al., made elastic."""

    name = "affinity"

    def __init__(self, seed: int = 0, vnodes: int = 64):
        super().__init__(seed)
        self.vnodes = vnodes
        self._ring: list[tuple[int, int]] = []  # (point, node index)
        self._points: list[int] = []

    def _build(self, nodes) -> None:
        self._ring = sorted(
            (_hash64(f"{n.node_id}:{v}:{self.seed}"), i)
            for i, n in enumerate(nodes) for v in range(self.vnodes))
        self._points = [p for p, _ in self._ring]

    def on_topology_change(self, nodes):
        self._build(nodes)

    def select(self, task, nodes, t):
        return self.owner(task.func_id, nodes)

    def owner(self, func_id: int, nodes) -> int:
        """Ring lookup without dispatching (affinity-stability tests)."""
        if len(self._ring) != len(nodes) * self.vnodes:
            self._build(nodes)
        j = bisect.bisect_right(self._points, _hash64(f"f{func_id}"))
        return self._ring[j % len(self._ring)][1]


class WarmAffinityDispatch(AffinityDispatch):
    """Affinity routing on observed warm state, not just the hash ring.

    The ring concentrates a function on one node, which is what *builds*
    warmth — but heartbeats know where warm sandboxes actually are (a
    node added last minute owns ring ranges it has never served; a
    capacity eviction can leave the ring owner cold while a spill target
    is warm). Preference order: warm node (least-loaded among them) >
    ring owner while its load is below ``spill_load`` > least-loaded.
    """

    name = "warm_affinity"

    def __init__(self, seed: int = 0, vnodes: int = 64,
                 spill_load: float = 2.0):
        super().__init__(seed, vnodes)
        self.spill_load = spill_load

    def select(self, task, nodes, t):
        snaps = [n.snapshot() for n in nodes]
        warm = [i for i, s in enumerate(snaps)
                if s.get("warm", {}).get(task.func_id)]
        if warm:
            return min(warm, key=lambda i: (snaps[i]["load"], i))
        home = self.owner(task.func_id, nodes)
        if snaps[home]["load"] <= self.spill_load:
            return home
        return min(range(len(nodes)), key=lambda i: (snaps[i]["load"], i))


class WarmLeastLoadedDispatch(LeastLoadedDispatch):
    """Least-loaded with warm tie-breaking: load balance first, but when
    several nodes are within ``slack`` load of the minimum, take the one
    already holding a warm sandbox for this function."""

    name = "least_loaded_warm"

    def __init__(self, seed: int = 0, slack: float = 0.5):
        super().__init__(seed)
        self.slack = slack

    def select(self, task, nodes, t):
        snaps = [n.snapshot() for n in nodes]
        lo = min(s["load"] for s in snaps)
        cands = [i for i, s in enumerate(snaps)
                 if s["load"] <= lo + self.slack]
        warm = [i for i in cands
                if snaps[i].get("warm", {}).get(task.func_id)]
        pool = warm or cands
        return min(pool, key=lambda i: (snaps[i]["load"], i))


class CostAwareDispatch(Dispatcher):
    """Route by estimated marginal dollars, not queue lengths.

    score(node) = cold_penalty_ms x price_per_ms(mem)
                + load x queue_ms_per_load x price_per_ms(mem)

    The first term is the billed sandbox boot the user pays if the node
    has no warm container for the function (zero on nodes without a
    container layer); the second converts node load into an equivalent
    billed-ms penalty — under fair-share scheduling, contention directly
    inflates the wall-clock execution the provider meters.

    The conversion coefficient is LEARNED online (``learn=True``, the
    default): the fleet loop feeds completions back, each yielding one
    observation (load at dispatch, billed-ms inflation over the pure
    demand: execution - init - service). A scalar recursive
    least-squares fit through the origin with forgetting factor
    ``rls_lambda`` tracks inflation-per-unit-load; ``queue_ms_per_load``
    seeds it as a prior worth ``prior_weight`` squared-load units of
    evidence, so an unobserved fleet routes exactly like the fixed-
    coefficient dispatcher and the estimate moves only as real evidence
    accumulates. Everything is deterministic: no sampling, and feedback
    arrives in canonical (completion, tid) order.

    The estimator itself is ``costmodel.online.ScalarRLS`` — the online
    half of the cost-model substrate. A learned ``CostModel`` seeds
    ``queue_ms_per_load`` with its calibrated coefficient (and may
    share its RLS instance outright via ``rls=``, so routing and the
    model report one value); ``pricing`` prices routes with a
    non-default :class:`~repro_torch.costmodel.pricing.PricingSpec`.
    ``snapshot()`` exposes the learned state (coefficient, observation
    count, realized prediction error) for the summary schema.
    """

    name = "cost_aware"

    def __init__(self, seed: int = 0, queue_ms_per_load: float = 1_000.0,
                 learn: bool = True, rls_lambda: float = 0.98,
                 prior_weight: float = 25.0, pricing=None, rls=None):
        super().__init__(seed)
        self.queue_ms_per_load = queue_ms_per_load
        self.learn = learn
        # A frozen dispatcher must not make the fleet loop harvest
        # completions it will ignore.
        self.wants_feedback = learn
        self.rls_lambda = rls_lambda
        self.pricing = pricing
        self.rls = rls if rls is not None else ScalarRLS(
            queue_ms_per_load, prior_weight=prior_weight,
            lam=rls_lambda, learn=learn)
        # tid -> load of the chosen node at dispatch time.
        self._dispatch_load: dict[int, float] = {}

    @property
    def coeff(self) -> float:
        """Current load -> billed-ms conversion (the learned slope)."""
        if not self.learn:
            return self.queue_ms_per_load
        return self.rls.coeff

    @property
    def n_observed(self) -> int:
        return self.rls.n_observed

    def snapshot(self) -> dict:
        """Learned-state roll-up (summary schema: cost_coeff /
        cost_obs / cost_pred_err_ms)."""
        return {
            "coeff": self.coeff,
            "n_observed": self.rls.n_observed,
            "queue_ms_per_load": self.queue_ms_per_load,
            "mean_abs_err_ms": self.rls.mean_abs_err,
            "learn": self.learn,
        }

    def observe_completion(self, task):
        load = self._dispatch_load.pop(task.tid, None)
        if not self.learn or load is None or load <= 0.0:
            return  # a zero-load dispatch carries no slope information
        if task.completion is None or task.first_run is None:
            return
        inflation = max(0.0, task.execution - task.init_ms - task.service)
        self.rls.observe(load, inflation)

    def select(self, task, nodes, t):
        p = price_per_ms(task.mem_mb, self.pricing)
        coeff = self.coeff
        topo = self.topology
        home = topo.home_zone(task.func_id) if topo is not None else None
        best, best_score, best_load = 0, None, 0.0
        for i, node in enumerate(nodes):
            s = node.snapshot()
            cold = 0.0
            if "warm" in s and not s["warm"].get(task.func_id):
                # Price with the node's advertised cold-start model
                # (heartbeat), so overridden ContainerConfig knobs are
                # reflected in routing.
                base, per_gb = s.get("cold_model", (None, None))
                cold = expected_cold_ms(task.mem_mb) if base is None \
                    else expected_cold_ms(task.mem_mb, base, per_gb)
            score = cold * p + s["load"] * coeff * p
            # SKU-aware pricing: the billed-ms terms scale by the
            # node's effective $/ms multiplier (spot discount folded
            # in), and a dispatch outside the home zone adds the hop's
            # latency priced like billed time. Multiplying by an exact
            # 1.0 and adding nothing keeps flat fleets bit-identical.
            mult = getattr(node, "price_mult", 1.0)
            if mult != 1.0:
                score *= mult
            if home is not None and node.zone is not None \
                    and node.zone != home:
                score += topo.cross_zone_ms * p
            if best_score is None or score < best_score:
                best, best_score, best_load = i, score, s["load"]
        if self.learn:
            self._dispatch_load[task.tid] = best_load
        return best


DISPATCHERS = {
    "random": RandomDispatch,
    "round_robin": RoundRobinDispatch,
    "least_loaded": LeastLoadedDispatch,
    "join_idle_queue": JoinIdleQueueDispatch,
    "affinity": AffinityDispatch,
    "warm_affinity": WarmAffinityDispatch,
    "least_loaded_warm": WarmLeastLoadedDispatch,
    "cost_aware": CostAwareDispatch,
}


def make_dispatcher(name: str, **kw) -> Dispatcher:
    if name not in DISPATCHERS:
        raise KeyError(f"unknown dispatcher {name!r}; "
                       f"have {sorted(DISPATCHERS)}")
    return DISPATCHERS[name](**kw)
