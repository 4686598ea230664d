"""Multi-node fleet simulation composing per-node schedulers (own copy
of ``repro.cluster.sim``).

``ClusterSim`` owns N ``ClusterNode`` handles, each wrapping one
single-node :class:`~repro_torch.core.events.Scheduler` (any policy from
``core.simulate.POLICIES``; heterogeneous mixes allowed). The cluster
loop walks a merged time-ordered stream — provisioning actions, chaos
events, invocation dispatches — in (time, kind) order: before each
routing decision every node is stepped to the instant, so state-aware
dispatchers (least-loaded, join-idle-queue) observe exactly what a
heartbeat at that instant would report. After the last event the nodes
drain independently — their event streams no longer interact.

Resilience & elasticity layers (DESIGN.md Sec. 14). The chaos,
admission, and prewarm layers are off by default and bit-identical to
the plain fleet when off; the one deliberate default change is the
``cost_aware`` dispatcher, which now LEARNS its coefficient from
completion feedback (construct it with ``learn=False`` for the
fixed-constant routing).

* ``chaos=``      a :class:`~repro_torch.cluster.chaos.ChaosSchedule` of
                  declarative kill/heal/flush_warm events applied
                  mid-run; a kill requeues the victim's in-flight work
                  through the front-end dispatcher.
* ``admission=``  an :class:`~repro_torch.cluster.admission.AdmissionControl`
                  (or config) consulted before routing: invocations are
                  admitted, queued at the front door, spilled to the
                  least-loaded node, or shed (priced separately).
* ``prewarm=``    a :class:`~repro_torch.cluster.prewarm.Provisioner` (or
                  plan) that places predicted warm sandboxes into node
                  pools ahead of per-minute bursts.
* learning dispatchers (``cost_aware``) receive completion feedback in
  canonical (completion, tid) order as the run advances.

Failure-domain topology (DESIGN.md Sec. 17). ``topology=`` attaches a
:class:`~repro_torch.cluster.topology.TopologySpec`: nodes carry zone/rack/
SKU labels, correlated chaos actions (``kill_zone`` / ``kill_rack`` /
``revoke_spot`` / ``degrade`` / ``restore``) target whole failure
domains, dispatch outside an invocation's home zone pays the priced
``cross_zone_ms`` latency penalty, and per-node SKU price multipliers
flow into the fleet bill. ``run(retry=...)`` routes chaos-lost work
through a :class:`~repro_torch.cluster.retry.RetryPolicy` (capped exponential
backoff with deterministic jitter, retry budget, per-function circuit
breaker shedding through the admission books) instead of the default
instant requeue. With a per-function concurrency cap configured
(``ContainerSpec(max_concurrency=...)``), the dispatch path routes
through the pool slot API: over-cap dispatches wait at the node and are
injected when a slot frees — the cap shapes simulated traffic.
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import math
import warnings
from typing import Optional, Sequence, Union

from ..core.containers import (ContainerConfig, ContainerSpec,
                               as_container_config)
from ..core.events import Scheduler, Task
from ..core.metrics import collect
from ..core.simulate import make_scheduler
from .admission import AdmissionConfig, AdmissionControl, make_admission
from .chaos import TOPOLOGY_ACTIONS, ChaosSchedule
from .dispatch import Dispatcher, make_dispatcher
from .metrics import ClusterResult
from .prewarm import Provisioner
from .retry import RetryPolicy, RetryState, make_retry
from .topology import NodePlacement, SlowdownDial, TopologySpec

# Merged-stream event classes: provisioning at an instant precedes chaos
# at it, which precedes dispatches at it (a node killed at t is gone for
# a same-instant arrival; a sandbox pre-warmed at t is warm for it).
_PREWARM, _CHAOS, _DISPATCH = 0, 1, 2


class ClusterNode:
    """One host in the fleet: a scheduler plus dispatch bookkeeping."""

    def __init__(self, node_id: str, sched: Scheduler, policy: str,
                 place: Optional[NodePlacement] = None):
        self.node_id = node_id
        self.sched = sched
        self.policy = policy
        self.assigned = 0
        # Every task ever injected here (chaos kills walk it for
        # in-flight requeue) and the completion-feedback watermark.
        self.inflight: list[Task] = []
        self.harvested = 0
        # Failure-domain labels (None on flat fleets): zone/rack are
        # the correlated-chaos targets, the SKU carries clock/price/
        # cold-profile/spot, and price_mult is the EFFECTIVE billed-$
        # multiplier (spot discount folded in) the roll-up applies.
        self.zone = place.zone if place is not None else None
        self.rack = place.rack if place is not None else None
        self.sku = place.sku if place is not None else None
        self.spot = place.sku.spot if place is not None else False
        self.price_mult = (place.sku.effective_price_mult
                           if place is not None else 1.0)
        # Slow-not-dead state: the interference dial (set for non-unit
        # SKU clocks and by chaos ``degrade``) and the open degrade
        # interval start (degraded-time accounting).
        self.dial: Optional[SlowdownDial] = None
        self.degrade_since: Optional[float] = None
        # Per-function concurrency-cap bookkeeping (pool slot API):
        # dispatches waiting for a slot (tid -> (task, earliest inject
        # instant)), running slot holders (tid -> (func_id, mem_mb)),
        # and the completed-list watermark the release scan resumes at.
        self.slot_waiters: dict[int, tuple[Task, float]] = {}
        self.slot_holders: dict[int, tuple[int, float]] = {}
        self.slot_harvested = 0

    def prime(self) -> None:
        self.sched.prime([])

    def inject(self, task: Task, t: float) -> None:
        self.assigned += 1
        self.inflight.append(task)
        self.sched.inject(task, t)

    def step(self, until: float) -> None:
        self.sched.step(until)

    def drain(self) -> None:
        self.sched.drain()

    def snapshot(self) -> dict:
        return self.sched.load_snapshot()


NodeSpec = Union[str, tuple]  # "hybrid" or ("hybrid", {kwargs})


def _make_node(i: int, spec: NodeSpec, cores_per_node: int,
               node_factory=None,
               containers: Optional[ContainerConfig] = None,
               seed: int = 0,
               place: Optional[NodePlacement] = None) -> ClusterNode:
    if isinstance(spec, str):
        policy, kw = spec, {}
    else:
        policy, kw = spec[0], dict(spec[1])
    if containers is not None:
        # Fleet-wide container config; per-spec kwargs still win, and
        # each node's pool gets its own deterministic seed stream. A
        # placed node's SKU may override the cold-start profile (a
        # newer machine generation boots sandboxes faster).
        if place is not None:
            over = {k: v for k, v in
                    (("cold_base_ms", place.sku.cold_base_ms),
                     ("cold_per_gb_ms", place.sku.cold_per_gb_ms))
                    if v is not None}
            if over:
                containers = dataclasses.replace(containers, **over)
        kw.setdefault("containers", containers)
        kw.setdefault("seed", seed + i)
    if node_factory is not None:
        sched = node_factory(policy, n_cores=cores_per_node, **kw)
    else:
        sched = make_scheduler(policy, n_cores=cores_per_node, **kw)
    node = ClusterNode(f"node{i}", sched, policy, place=place)
    if place is not None and place.sku.clock != 1.0:
        # Non-unit SKU clock rides the interference channel: attached
        # post-construction so ANY node factory (serving slot
        # schedulers included) gets the same treatment.
        node.dial = SlowdownDial(clock=place.sku.clock)
        sched.set_interference(node.dial)
    return node


def _reset_for_retry(task: Task) -> None:
    """A chaos kill loses the victim's progress: the invocation restarts
    from scratch elsewhere. Queueing stays measured from the TRUE
    arrival; the billed execution span is the successful attempt's."""
    task.remaining = task.service
    task.cpu_time = 0.0
    task.first_run = None
    task.completion = None
    task.vruntime = 0.0
    task.cold_start = False
    task.init_ms = 0.0
    task.retries += 1


class ClusterSim:
    """Fleet of nodes behind a pluggable front-end dispatcher.

    ``node_policies`` is either one policy applied fleet-wide or a
    per-node list (heterogeneous fleets — e.g. half hybrid, half CFS).
    ``node_factory`` overrides scheduler construction for domains whose
    schedulers need extra arguments (the serving gateway's slot
    schedulers). ``containers`` attaches the sandbox lifecycle layer to
    every node: each gets its own memory-bounded warm pool, heartbeats
    report warm-set contents, and warm-aware dispatchers route on them.
    ``admission`` attaches the front-door guard (see module docstring).
    """

    def __init__(self,
                 n_nodes: int = 4,
                 cores_per_node: int = 16,
                 node_policies: Union[NodeSpec, Sequence[NodeSpec]] = "hybrid",
                 dispatcher: Union[str, Dispatcher] = "least_loaded",
                 seed: int = 0,
                 node_factory=None,
                 containers: Union[None, ContainerConfig, ContainerSpec,
                                   dict, str] = None,
                 admission: Union[None, AdmissionConfig,
                                  AdmissionControl] = None,
                 topology: Optional[TopologySpec] = None):
        # A topology IS the fleet shape: it decides the node count and
        # every node's zone/rack/SKU placement.
        if topology is not None:
            n_nodes = topology.n_nodes
        if n_nodes < 1:
            raise ValueError("a fleet needs at least one node")
        # Any accepted ``containers=`` shape normalizes to a pool config
        # here, before nodes are built. Workload-driven histogram hints
        # need the task list and so cannot be derived at construction
        # time — Scenario materializes hinted configs before this point.
        containers = as_container_config(containers)
        if isinstance(node_policies, (str, tuple)):
            node_policies = [node_policies] * n_nodes
        if len(node_policies) != n_nodes:
            raise ValueError(
                f"{len(node_policies)} node policies for {n_nodes} nodes")
        self.node_factory = node_factory
        self.containers = containers
        self.seed = seed
        self.topology = topology
        places = topology.placement() if topology is not None \
            else [None] * n_nodes
        self.nodes = [_make_node(i, spec, cores_per_node, node_factory,
                                 containers=containers, seed=seed,
                                 place=places[i])
                      for i, spec in enumerate(node_policies)]
        # Monotonic id counter: node ids must stay unique across
        # add/remove churn or the affinity ring maps two nodes to the
        # same hash points.
        self._next_node_id = n_nodes
        self.cores_per_node = cores_per_node
        if isinstance(dispatcher, str):
            dispatcher = make_dispatcher(dispatcher, seed=seed)
        self.dispatcher = dispatcher
        if topology is not None:
            self.dispatcher.attach_topology(topology)
        self.dispatcher.on_topology_change(self.nodes)
        self.admission = make_admission(admission)
        # (tid, node_id): ids stay valid across add/remove churn, where
        # live-list indices shift.
        self.assignments: list[tuple[int, str]] = []
        self._retired: list[ClusterNode] = []
        self.shed: list[Task] = []          # front-door rejects
        self.chaos_log: list[dict] = []     # one record per chaos event
        self._provisioner: Optional[Provisioner] = None
        self._retry: Optional[RetryState] = None
        self.cross_zone = 0                 # out-of-home-zone dispatches
        self._degraded_closed_ms = 0.0      # closed degrade intervals
        # Per-function concurrency cap (slot-routed dispatch) — None
        # keeps the historical direct-inject path, bit-identically.
        self._slot_cap = containers.max_concurrency \
            if containers is not None else None

    # -- elasticity --------------------------------------------------------
    def add_node(self, spec: NodeSpec = "hybrid") -> ClusterNode:
        place = self.topology.heal_placement() \
            if self.topology is not None else None
        node = _make_node(self._next_node_id, spec, self.cores_per_node,
                          self.node_factory, containers=self.containers,
                          seed=self.seed, place=place)
        self._next_node_id += 1
        node.prime()
        self.nodes.append(node)
        self.dispatcher.on_topology_change(self.nodes)
        return node

    def remove_node(self, index: int,
                    t: Optional[float] = None) -> ClusterNode:
        """Gracefully drain and decommission a node (its in-flight work
        completes and is still counted in the fleet roll-up via
        ``_retired``). ``t`` steps the node to the removal instant
        first. Decommission closes the node's warm pool at removal —
        the memory-hold meter stops, the warm set is destroyed, and the
        parked keep-alive reaper dies with the machine instead of
        leaking an open meter into later roll-ups. Queued slot waiters
        are granted (drain + release cycles) before decommission, so a
        graceful removal never strands a dispatch."""
        node = self.nodes[index]
        if t is not None:
            node.step(t)
        node.drain()
        guard = 0
        while node.slot_waiters:
            self._service_slots([node])
            node.drain()
            guard += 1
            if guard > len(node.inflight) + 1:
                raise RuntimeError("slot waiters cannot make progress "
                                   "on a draining node")
        self._decommission(index, t)
        return node

    def _decommission(self, index: int, t: Optional[float]) -> None:
        """Shared tail of graceful removal and chaos kill: harvest the
        node's final completion feedback, detach it, close its warm
        pool and parked timers at ``t``, close any open degrade
        interval, and retire its roll-up row."""
        node = self.nodes[index]
        if self.dispatcher.wants_feedback:
            self._harvest()  # its completions still teach
        self.nodes.pop(index)
        node.sched.shutdown(t)
        if node.degrade_since is not None:
            end = node.sched.now if t is None else max(t, node.degrade_since)
            self._degraded_closed_ms += end - node.degrade_since
            node.degrade_since = None
        self._retired.append(node)
        self.dispatcher.on_topology_change(self.nodes)

    # -- chaos -------------------------------------------------------------
    def _find_node(self, node_id: Optional[str]) -> Optional[int]:
        if node_id is None:
            return 0 if self.nodes else None
        for i, n in enumerate(self.nodes):
            if n.node_id == node_id:
                return i
        return None

    def _match_nodes(self, ev) -> list[ClusterNode]:
        """Live nodes a chaos event targets, in fleet order (the
        deterministic expansion of a correlated event)."""
        if ev.action == "kill_zone":
            return [n for n in self.nodes if n.zone == ev.zone]
        if ev.action == "kill_rack":
            return [n for n in self.nodes if n.rack == ev.rack]
        if ev.action == "revoke_spot":
            return [n for n in self.nodes if n.spot and
                    (ev.zone is None or n.zone == ev.zone)]
        # degrade / restore: zone > rack > node id > first live node.
        if ev.zone is not None:
            return [n for n in self.nodes if n.zone == ev.zone]
        if ev.rack is not None:
            return [n for n in self.nodes if n.rack == ev.rack]
        idx = self._find_node(ev.node)
        return [] if idx is None else [self.nodes[idx]]

    def _kill_nodes(self, victims: list[ClusterNode], t: float,
                    requeue, rec: dict) -> None:
        """Shared kill body, single-node and correlated: the machines
        are simply gone at ``t`` (no drain). Lost in-flight work flows
        through the retry policy (or requeues instantly without one);
        queued slot waiters never started, so they re-dispatch
        immediately with no retry penalty."""
        lost: list[Task] = []
        stranded: list[Task] = []
        for node in victims:
            node.step(t)
            lost.extend(x for x in node.inflight
                        if x.completion is None and not x.failed)
            stranded.extend(task for task, _ in node.slot_waiters.values())
            node.slot_waiters.clear()
            node.slot_holders.clear()
            self._decommission(self.nodes.index(node), t)
        for x in sorted(stranded, key=lambda x: (x.arrival, x.tid)):
            requeue(x, t)
        rec["slot_requeued"] = len(stranded)
        for x in sorted(lost, key=lambda x: (x.arrival, x.tid)):
            self._retry_or_requeue(x, t, requeue, rec)

    def _retry_or_requeue(self, task: Task, t: float, requeue,
                          rec: dict) -> None:
        """Route one chaos-lost invocation: instant requeue without a
        policy (the default semantics, bit-identical), else backoff-delayed
        retry, budget- or breaker-shed through the admission books."""
        if self._retry is None:
            _reset_for_retry(task)
            requeue(task, t)
            rec["requeued"] += 1
            return
        verdict, when = self._retry.on_failure(task, t)
        if verdict == "shed":
            task.failed = True
            self.shed.append(task)
            if self.admission is not None:
                self.admission.on_retry_shed(task)
            rec["retry_shed"] = rec.get("retry_shed", 0) + 1
            return
        _reset_for_retry(task)
        requeue(task, when)
        rec["requeued"] += 1

    def _degrade(self, node: ClusterNode, t: float,
                 severity: float) -> None:
        """Slow-not-dead: steal ``severity`` of the node's clock via
        the interference dial (composes with the SKU clock). Nothing is
        requeued — everything there just runs slower."""
        if node.dial is None:
            clock = node.sku.clock if node.sku is not None else 1.0
            node.dial = SlowdownDial(clock=clock)
            node.sched.set_interference(node.dial)
        node.dial.degrade = severity
        if node.degrade_since is None:
            node.degrade_since = t

    def _restore(self, node: ClusterNode, t: float) -> None:
        if node.dial is not None:
            node.dial.degrade = 0.0
        if node.degrade_since is not None:
            self._degraded_closed_ms += t - node.degrade_since
            node.degrade_since = None

    def _apply_chaos(self, ev, t: float, requeue) -> None:
        rec = {"t": t, "action": ev.action, "node": ev.node,
               "requeued": 0, "warm_flushed": 0}
        if ev.action == "heal":
            spec = ev.spec if ev.spec is not None else self._heal_spec
            node = self.add_node(spec)
            node.step(t)
            rec["node"] = node.node_id
        elif ev.action in ("kill_zone", "kill_rack", "revoke_spot"):
            victims = self._match_nodes(ev)
            rec["nodes"] = [n.node_id for n in victims]
            if ev.action == "revoke_spot":
                rec["revoked"] = len(victims)
            if not victims:
                rec["action"] += ":noop"  # domain already empty
            else:
                self._kill_nodes(victims, t, requeue, rec)
        elif ev.action in ("degrade", "restore"):
            targets = self._match_nodes(ev)
            rec["nodes"] = [n.node_id for n in targets]
            if not targets:
                rec["action"] += ":noop"
            for node in targets:
                node.step(t)
                if ev.action == "degrade":
                    self._degrade(node, t, ev.severity)
                else:
                    self._restore(node, t)
            if ev.action == "degrade":
                rec["severity"] = ev.severity
        else:
            idx = self._find_node(ev.node)
            if idx is None:
                rec["action"] += ":noop"  # target already gone
                self.chaos_log.append(rec)
                return
            node = self.nodes[idx]
            node.step(t)
            rec["node"] = node.node_id
            if ev.action == "flush_warm":
                pool = getattr(node.sched, "containers", None)
                if pool is not None:
                    rec["warm_flushed"] = pool.flush(t)
            else:  # kill: no drain — the machine is simply gone
                self._kill_nodes([node], t, requeue, rec)
        self.chaos_log.append(rec)

    # -- per-function concurrency slots ------------------------------------
    def _dispatch_to(self, node: ClusterNode, task: Task, t: float,
                     t_inject: float) -> None:
        """Inject through the pool slot API when a per-function cap is
        configured: an over-cap dispatch parks at the node until a
        completion frees a slot (the cap shapes simulated
        traffic). ``t`` is the routing instant (pool clock); ``t_inject``
        is the arrival at the node (>= t under a cross-zone hop)."""
        pool = getattr(node.sched, "containers", None) \
            if self._slot_cap is not None else None
        if pool is None:
            node.inject(task, t_inject)
            return
        status = pool.request_slot(task.func_id, task.mem_mb, t,
                                   tid=task.tid, claim=False)
        if status == "queued":
            node.slot_waiters[task.tid] = (task, t_inject)
            return
        node.slot_holders[task.tid] = (task.func_id, task.mem_mb)
        node.inject(task, t_inject)

    def _service_slots(self,
                       nodes: Optional[list[ClusterNode]] = None) -> None:
        """Release concurrency slots for completions past each node's
        watermark (canonical (completion, tid) order) and inject any
        waiters those releases grant. Grants are observed at heartbeat
        instants — the next front-door event, or drain boundaries in
        the tail — because the cluster loop has no clock between
        events; the engine clamps the injection to its own ``now``, so
        a waiter's queueing is still measured from true arrival."""
        if self._slot_cap is None:
            return
        for node in (self.nodes if nodes is None else nodes):
            done = node.sched.completed
            if len(done) <= node.slot_harvested:
                continue
            fresh = [x for x in done[node.slot_harvested:]
                     if x.tid in node.slot_holders]
            node.slot_harvested = len(done)
            if not fresh:
                continue
            fresh.sort(key=lambda x: (x.completion, x.tid))
            pool = getattr(node.sched, "containers", None)
            for x in fresh:
                fid, mem = node.slot_holders.pop(x.tid)
                if pool is None:
                    continue
                grants = pool.release_slot(fid, mem, x.completion,
                                           keep_warm=False, claim=False)
                for tid, _status in grants:
                    entry = node.slot_waiters.pop(tid, None)
                    if entry is None:
                        continue
                    waiter, t_inject = entry
                    node.slot_holders[waiter.tid] = (waiter.func_id,
                                                     waiter.mem_mb)
                    node.inject(waiter, max(x.completion, t_inject))

    # -- learning-dispatcher feedback --------------------------------------
    def _harvest(self) -> None:
        """Feed newly completed tasks to a learning dispatcher, in
        canonical (completion, tid) order so the feedback stream never
        depends on node iteration order."""
        batch: list[Task] = []
        for node in self.nodes:
            done = node.sched.completed
            if len(done) > node.harvested:
                batch.extend(done[node.harvested:])
                node.harvested = len(done)
        if batch:
            batch.sort(key=lambda x: (x.completion, x.tid))
            for task in batch:
                self.dispatcher.observe_completion(task)

    # -- simulation --------------------------------------------------------
    def run(self, workload: list[Task], *,
            fresh_tasks: bool = True,
            chaos: Optional[ChaosSchedule] = None,
            prewarm: Union[None, Provisioner, Sequence] = None,
            retry: Union[None, dict, RetryPolicy, RetryState] = None,
            ) -> ClusterResult:
        tasks = copy.deepcopy(workload) if fresh_tasks else workload
        tasks = sorted(tasks, key=lambda x: (x.arrival, x.tid))
        if chaos is not None and self.topology is None:
            for ev in chaos:
                if ev.action in TOPOLOGY_ACTIONS or ev.zone is not None \
                        or ev.rack is not None:
                    raise ValueError(
                        f"chaos action {ev.action!r} targets a failure "
                        "domain, but the fleet has no topology= attached")
        self._retry = make_retry(retry, seed=self.seed)
        if prewarm is not None and not isinstance(prewarm, Provisioner):
            prewarm = Provisioner(prewarm)
        if prewarm is not None and prewarm.rows_applied:
            # A consumed cursor would silently provision NOTHING and
            # report the previous run's stats as this run's.
            raise ValueError("Provisioner already consumed by a previous "
                             "run; build a fresh one per run")
        self._provisioner = prewarm
        # Heal events without an explicit spec bring up the schedule's
        # default node policy.
        self._heal_spec = chaos.heal_spec if chaos is not None else "hybrid"
        for node in self.nodes:
            node.prime()

        # Merged stream: (t, class, seq, payload, first). ``first`` is
        # False when an admission-queued task is re-presented (its rate
        # token is already reserved) and None for a chaos-requeued task
        # (already admitted once — the fleet owes it execution, so it
        # bypasses admission entirely on retry).
        stream: list = []
        seq = 0
        for task in tasks:
            stream.append((task.arrival, _DISPATCH, seq, task, True))
            seq += 1
        if chaos is not None:
            for ev in chaos:
                stream.append((ev.t, _CHAOS, seq, ev, True))
                seq += 1
        if prewarm is not None:
            # Rows are applied in bulk by apply_due; one stream entry
            # per distinct provisioning instant keeps the heap small.
            for t_prov in sorted({row[0] for row in prewarm.plan}):
                stream.append((t_prov, _PREWARM, seq, None, True))
                seq += 1
        heapq.heapify(stream)

        feedback = self.dispatcher.wants_feedback

        def requeue(task: Task, t: float) -> None:
            nonlocal seq
            heapq.heappush(stream, (t, _DISPATCH, seq, task, None))
            seq += 1

        while stream:
            t, klass, _, payload, first = heapq.heappop(stream)
            if klass == _PREWARM:
                # Bring every node to the provisioning instant FIRST:
                # pool op timestamps stay monotone and no pending event
                # before t can warm-hit a sandbox that does not exist
                # yet at its own instant.
                for node in self.nodes:
                    node.step(t)
                self._service_slots()
                prewarm.apply_due(t, self.nodes, self.dispatcher)
                continue
            if klass == _CHAOS:
                self._apply_chaos(payload, t, requeue)
                continue
            task = payload
            t = max(t, task.arrival)
            if not self.nodes:
                # Chaos emptied the fleet: nothing can serve this. The
                # admission books must still balance (refund any rate
                # token the task holds, count the shed).
                task.failed = True
                self.shed.append(task)
                if self.admission is not None:
                    self.admission.on_external_shed(task)
                continue
            for node in self.nodes:
                node.step(t)
            self._service_slots()
            if feedback:
                self._harvest()
            forced = None
            if self.admission is not None and first is not None:
                need_load = math.isfinite(self.admission.cfg.max_load)
                # The guard needs only occupancy, not the full
                # heartbeat (the warm-set live_view is the expensive
                # part) — and the dispatcher takes its own snapshots.
                loads = [{"load": (n.sched.n_running() + n.sched.n_queued())
                          / n.sched.n_cores} for n in self.nodes] \
                    if need_load else []
                outcome, when = self.admission.decide(task, loads, t,
                                                      first=first)
                if outcome == "shed":
                    task.failed = True
                    self.shed.append(task)
                    continue
                if outcome == "queue":
                    heapq.heappush(stream,
                                   (when, _DISPATCH, seq, task, False))
                    seq += 1
                    continue
                if outcome == "spill":
                    # Spill prefers the invocation's home zone: a
                    # cross-zone hop costs priced latency, so overflow
                    # only leaves the zone when it is entirely full.
                    pool_idx = range(len(self.nodes))
                    if self.topology is not None:
                        home = self.topology.home_zone(task.func_id)
                        local = [i for i in pool_idx
                                 if self.nodes[i].zone == home]
                        if local:
                            pool_idx = local
                    forced = min(pool_idx,
                                 key=lambda i: (loads[i]["load"], i))
            i = forced if forced is not None else \
                self.dispatcher.select(task, self.nodes, t)
            node = self.nodes[i]
            self.assignments.append((task.tid, node.node_id))
            t_inject = t
            if self.topology is not None and node.zone is not None \
                    and node.zone != self.topology.home_zone(task.func_id):
                self.cross_zone += 1
                t_inject = t + self.topology.cross_zone_ms
            self._dispatch_to(node, task, t, t_inject)

        for node in self.nodes:
            node.drain()
        # Slot waiters parked at nodes are granted as drained
        # completions free slots; each grant injects new work, so
        # drain/service cycles until the books are empty. A pass that
        # grants nothing while waiters remain is a wedged cap.
        if self._slot_cap is not None:
            while any(n.slot_waiters for n in self.nodes):
                before = sum(len(n.slot_waiters) for n in self.nodes)
                self._service_slots()
                for node in self.nodes:
                    node.drain()
                if sum(len(n.slot_waiters) for n in self.nodes) >= before:
                    raise RuntimeError("queued slot waiters cannot make "
                                       "progress after fleet drain")
            self._service_slots()  # final release scan empties holders
        if feedback:
            self._harvest()
        return self.result()

    def result(self) -> ClusterResult:
        everything = self.nodes + getattr(self, "_retired", [])
        per_node = [collect(n.sched, n.policy) for n in everything]
        # Degrade intervals still open at roll-up time end at each
        # node's own clock (the fleet has no later instant for them).
        degraded = self._degraded_closed_ms + sum(
            n.sched.now - n.degrade_since for n in self.nodes
            if n.degrade_since is not None)
        meta = [{"node_id": n.node_id, "zone": n.zone, "rack": n.rack,
                 "sku": n.sku.name if n.sku is not None else None,
                 "spot": n.spot, "price_mult": n.price_mult,
                 "base_price_mult": (n.sku.price_mult
                                     if n.sku is not None else 1.0),
                 "spot_discount": (n.sku.spot_discount
                                   if n.sku is not None and n.sku.spot
                                   else 0.0)}
                for n in everything]
        return ClusterResult(
            node_results=per_node,
            node_ids=[n.node_id for n in everything],
            node_policies=[n.policy for n in everything],
            dispatcher=self.dispatcher.name,
            cores_per_node=self.cores_per_node,
            assignments=list(self.assignments),
            n_retired=len(getattr(self, "_retired", [])),
            shed=list(self.shed),
            chaos_events=list(self.chaos_log),
            admission=self.admission.stats() if self.admission else None,
            prewarm_stats=(self._provisioner.stats()
                           if self._provisioner else None),
            node_meta=meta,
            cross_zone=self.cross_zone,
            retry_stats=(self._retry.stats()
                         if self._retry is not None else None),
            degraded_ms=degraded,
            dispatcher_state=(self.dispatcher.snapshot()
                              if hasattr(self.dispatcher, "snapshot")
                              else None),
        )


def run_cluster(workload: list[Task], *,
                n_nodes: int = 4,
                cores_per_node: int = 16,
                node_policy: Union[NodeSpec, Sequence[NodeSpec]] = "hybrid",
                dispatcher: str = "least_loaded",
                seed: int = 0,
                node_factory=None,
                containers: Union[None, ContainerConfig, ContainerSpec,
                                  dict, str] = None,
                admission: Union[None, AdmissionConfig,
                                 AdmissionControl] = None,
                chaos: Optional[ChaosSchedule] = None,
                prewarm: Union[None, Provisioner, Sequence] = None,
                ) -> ClusterResult:
    """Deprecated: build a :class:`repro_torch.Scenario` with a fleet spec
    and call ``repro_torch.run``. This shim routes through exactly that path
    (results stay bit-identical to the Scenario API)."""
    warnings.warn(
        "run_cluster() is deprecated; use repro_torch.run(Scenario(fleet="
        "FleetSpec(n_nodes=..., dispatcher=...), ...)) instead",
        DeprecationWarning, stacklevel=2)
    from ..scenario import (FleetSpec, PolicySpec, ResilienceSpec,
                            Scenario, WorkloadSpec, run)
    nodes = None
    if isinstance(node_policy, str):
        policy = PolicySpec(name=node_policy)
    elif isinstance(node_policy, tuple):
        policy = PolicySpec(name=node_policy[0],
                            kw=dict(node_policy[1]))
    else:  # heterogeneous per-node list
        nodes = tuple(node_policy)
        first = nodes[0]
        policy = PolicySpec(name=first if isinstance(first, str)
                            else first[0])
    sc = Scenario(
        workload=WorkloadSpec(kind="tasks", tasks=workload),
        fleet=FleetSpec(n_nodes=n_nodes, cores_per_node=cores_per_node,
                        dispatcher=dispatcher, containers=containers,
                        seed=seed, nodes=nodes,
                        node_factory=node_factory),
        policy=policy,
        resilience=ResilienceSpec(chaos=chaos, admission=admission,
                                  prewarm=prewarm))
    return run(sc).raw
