"""Event-driven simulator of one serverless host (own copy of
``repro.core.events``).

A deterministic discrete-event simulation of one big serverless host (the
paper uses 50 enclave cores of a 2x18C/2T Xeon). Scheduling policies
subclass :class:`Scheduler` and receive the same "message pump" a ghOSt
agent would: task arrival, chunk expiry (slice / time-limit), completion,
timers. Time is in milliseconds (float); the simulation is exact (no
ticks), and every float operation is the JAX package's, in its order, so
both engines give the same results bit for bit (DESIGN.md Sec. 13 sets
out the event loop: pooled heap records tombstoned on preemption, the
canonical same-instant order arrivals < timers < core expiries by core id,
inline expiries, and the analytic fast-forwards that retire whole runs of
slices and completions between barrier events).

The five regime helpers are the only places the simulator's float recipes
live, so the scalar engine, the batched engine's plain version and its
CUDA kernel execute the SAME operation sequences. Each takes
``_min``/``_max``, which the plain version binds to
``torch.minimum``/``torch.maximum``; on non-NaN operands those give
Python's ``min``/``max`` bit for bit.
"""
from __future__ import annotations

import heapq
from bisect import insort
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np

from .containers import (ContainerConfig, ContainerPool,
                         as_container_config)

ARRIVAL, CORE_EVT, TIMER, DEAD = 0, 1, 2, 3

# Group tags for two-level policies.
GROUP_FIFO = 0
GROUP_CFS = 1

_EPS = 1e-9
_INF = float("inf")


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


class Core:
    """One CPU core; holds at most one running chunk.

    ``pending`` is the core's in-flight expiry record in the scheduler
    heap, or None while the chunk is being advanced inline. Interrupting
    a chunk tombstones the record (lazy deletion) instead of bumping a
    generation counter.
    """

    __slots__ = (
        "cid", "task", "pending", "chunk_start", "chunk_work_start",
        "chunk_len", "chunk_rate", "group", "locked_until", "busy_ms",
        "last_task", "rq", "rq_seq", "min_vruntime", "preempt_count",
        "busy_snapshot", "_rs_snap", "ff_w",
    )

    def __init__(self, cid: int, group: int = GROUP_FIFO):
        self.cid = cid
        self.task: Optional[Task] = None
        self.pending: Optional[list] = None
        self.chunk_start = 0.0
        self.chunk_work_start = 0.0
        self.chunk_len = 0.0
        self.chunk_rate = 1.0
        self.group = group
        self.locked_until = -1.0
        self.busy_ms = 0.0
        self.last_task: Optional[Task] = None
        # CFS per-core runqueue: heap of (vruntime, seq, Task)
        self.rq: list = []
        self.rq_seq = 0
        self.min_vruntime = 0.0
        self.preempt_count = 0
        self.busy_snapshot = 0.0
        self._rs_snap = 0.0
        # Windowed fast-forward sizing hint: this core's last batch
        # length (purely a performance hint, never affects outcomes).
        self.ff_w = 1 << 20

    @property
    def nr_running(self) -> int:
        return len(self.rq) + (1 if self.task is not None else 0)

    def busy_total(self, now: float) -> float:
        if self.task is not None:
            return self.busy_ms + max(0.0, now - self.chunk_start)
        return self.busy_ms

    # The runqueue is kept SORTED (insort / pop(0)) rather than heapified:
    # pop-min semantics are identical, and the analytic fast-forward can
    # then read and splice the queue in place without re-sorting it on
    # every batch entry.
    def rq_push(self, task: Task) -> None:
        insort(self.rq, (task.vruntime, self.rq_seq, task))
        self.rq_seq += 1

    def rq_pop(self) -> Task:
        vr, _, task = self.rq.pop(0)
        self.min_vruntime = max(self.min_vruntime, vr)
        return task


class Scheduler:
    """Base event loop. Policies override the hooks at the bottom."""

    name = "base"
    # Policies with a constant-quantum slice cycle set this and implement
    # fast_forward() (see hybrid.py / policies.py); the event loop then
    # retires whole rounds analytically when no interacting event
    # intervenes.
    _has_ff = False
    # Restricts the analytic fast-forward to lone-task cores; see
    # HybridScheduler._ff_solo_only for the subclass contract.
    _ff_solo_only = False
    # Completion batching opt-out: a subclass whose on_complete hook is
    # order-SENSITIVE across cores beyond the buffered adapter/pool
    # channels (anything that must interleave with other cores' events
    # in exact global time order) sets this False, and its completions
    # serialize through the heap as before the batching overhaul.
    _batch_complete = True
    # Core groups whose chunk expiries can touch OTHER cores' state
    # (the hybrid FIFO group migrates over-limit tasks into CFS
    # runqueues): their expiry instants are fast-forward barriers.
    _barrier_groups: Optional[frozenset] = None

    def __init__(
        self,
        n_cores: int = 50,
        ctx_switch_ms: float = 0.06,
        util_sample_ms: float = 500.0,
        trace_util: bool = False,
        interference_fn: Optional[Callable[[float], float]] = None,
        containers: Optional[Union[ContainerPool, ContainerConfig,
                                   "ContainerSpec", dict, str]] = None,
        seed: int = 0,
    ):
        self.n_cores = n_cores
        self.ctx_switch_ms = ctx_switch_ms
        self.util_sample_ms = util_sample_ms
        self.trace_util = trace_util
        self.seed = seed
        # Container lifecycle layer (DESIGN.md Sec. 9): None keeps the
        # historical cold-start-free behaviour; any other accepted shape
        # (ContainerSpec / ContainerConfig / kwargs dict / policy name)
        # builds a per-node pool seeded from this scheduler's seed.
        if containers is not None and not isinstance(containers,
                                                     ContainerPool):
            containers = as_container_config(containers)
        if containers is not None and not isinstance(containers,
                                                     ContainerPool):
            containers = ContainerPool(containers, seed=seed)
        self.containers = containers
        # ghOSt mode: fraction of each enclave core stolen by NATIVE Linux
        # CFS tasks (freshly spawned, not yet pinned to the enclave) as a
        # function of time. The ghOSt scheduling class runs below CFS, so
        # spawn storms stall enclave tasks (paper Sec. VI, Table I FIFO
        # p99-execution artifact). None = idealized enclave.
        self.interference_fn = interference_fn
        self.cores = [Core(i) for i in range(n_cores)]
        self.heap: list = []
        self.seq = 0
        self.now = 0.0
        self.completed: list[Task] = []
        self.failed: list[Task] = []
        self.total_ctx = 0
        # Logical events processed (arrivals + chunk expiries/completions
        # + timers) — the engine-throughput denominator. Invariant under
        # engine-internal optimizations: two engines simulating the same
        # run count the same events, however they process them.
        self.n_events = 0
        self.util_series: list = []  # (t, per-group {group: util})
        self._timers: list[tuple[float, Callable]] = []
        self._primed = False
        self._parked_timers: dict = {}  # payload -> interval, revived on inject
        # Free pool of heap records; records are recycled when popped
        # (live or tombstoned), so the steady-state loop allocates no
        # event objects at all.
        self._pool: list[list] = []
        # step() horizon: inline chunk processing must not advance a
        # node past the time a cluster dispatcher stepped it to, or
        # heartbeat snapshots would observe the future.
        self._hz = _INF
        # Fast-forward barrier instants: the times of every pending
        # event that can interact with a core from outside — timers
        # (sampling, rightsizing, reaping) and interacting chunk
        # expiries (see _chunk_interacts) in ``_barriers``; arrivals in
        # ``_arr_barriers``, consulted only for cores the policy's
        # placement can actually touch (see _arrivals_touch: a hybrid
        # arrival enters the FIFO group's global queue and never reads
        # or mutates a CFS core). Pure slice expiries on OTHER cores
        # touch only their own core, so an analytic fast-forward may
        # cross them; it must stop strictly before the next barrier.
        # Stale times are popped lazily; tombstoned events leave a
        # conservative barrier behind. Maintained only when a
        # fast-forward can actually consume it (interference-rate
        # chunks always decline), so FIFO/EDF and ghost-mode runs pay
        # nothing on the arrival path.
        self._barriers: list[float] = []
        self._arr_barriers: list[float] = []
        self._use_ff = self._has_ff and interference_fn is None
        # Latest instant a fast-forward batch retired a completion at;
        # drain() reconciles the clock with it so end-of-run state
        # matches the event-by-event engine even when the final
        # completions never touched the heap.
        self._ff_now = 0.0

    # -- event machinery ------------------------------------------------
    def _push(self, t: float, kind: int, payload) -> list:
        # Canonical same-instant key: arrivals (class 0) before timers
        # (class 1) before core expiries (class 2, cid order). Arrivals
        # and timers keep a monotone seq among themselves — their pushes
        # happen at identical logical points in any equivalent engine,
        # so seq order is reproducible; core expiries must NOT use push
        # order (elision permutes it) and use the core id instead.
        if kind == CORE_EVT:
            klass, tie = 2, payload.cid
        else:
            klass, tie = (0 if kind == ARRIVAL else 1), self.seq
        pool = self._pool
        if pool:
            rec = pool.pop()
            rec[0] = t
            rec[1] = klass
            rec[2] = tie
            rec[3] = kind
            rec[4] = payload
        else:
            rec = [t, klass, tie, kind, payload]
        self.seq += 1
        heapq.heappush(self.heap, rec)
        if kind != CORE_EVT and self._use_ff:
            if kind == ARRIVAL:
                heapq.heappush(self._arr_barriers, t)
            else:
                heapq.heappush(self._barriers, (t, self.seq, None, 0.0))
        return rec

    def _chunk_barrier(self, core: Core, end: float) -> Optional[float]:
        """Earliest instant at which the chunk just installed on
        ``core`` — or anything this core does AFTER it, up to the next
        event this core pushes — can touch ANOTHER core's state. None
        when it never can. The returned time must be conservative (at
        or before the true first interaction): fast-forward batches on
        other cores run strictly before it. Policies refine this per
        chunk (the hybrid: a budget-limited FIFO chunk migrates AT its
        expiry; a completing one cannot trigger a migration earlier
        than its expiry plus the full static budget a fresh pick
        gets)."""
        bg = self._barrier_groups
        if bg is not None and core.group in bg:
            return end
        return None

    def _arrival_barrier_offset(self, core: Core) -> float:
        """How long after a pending ARRIVAL the earliest interaction
        with ``core`` can happen. 0.0 for single-level policies: the
        arrival's placement reads every core at its own instant. The
        hybrid overrides for CFS cores — an arrival enters the FIFO
        group's global queue and can only reach a CFS core via a later
        budget-expiry migration."""
        return 0.0

    def _push_core(self, core: Core, end: float) -> None:
        core.pending = self._push(end, CORE_EVT, core)
        if self._use_ff:
            bt = self._chunk_barrier(core, end)
            if bt is not None:
                # Tagged with the chunk's identity (core, chunk_start):
                # once this chunk is retired, its SUCCESSOR's barrier —
                # registered when the successor is pushed, and provably
                # no earlier than this one — supersedes it, so matured
                # entries from long-retired chunks are skipped instead
                # of pinning every batch to a stale conservative bound.
                heapq.heappush(self._barriers,
                               (bt, self.seq, core, core.chunk_start))
                self.seq += 1

    def _next_barrier(self, t: float, core: Optional[Core] = None) -> float:
        """Earliest pending interacting instant at/after ``t`` that can
        reach ``core`` (every event before ``t`` has been processed —
        the heap drains in time order). ``core=None`` is conservative:
        arrivals count immediately for everyone."""
        b = self._barriers
        while b:
            bt, _, c, cs = b[0]
            if bt < t or (c is not None
                          and (c.task is None or c.chunk_start != cs)):
                heapq.heappop(b)   # past, or the tagged chunk retired
            else:
                break
        bound = b[0][0] if b else _INF
        # Drain stale arrival instants (events before t are done; the
        # chunks they spawned registered their own barriers), then
        # apply the policy's reach offset for this core.
        a = self._arr_barriers
        while a and a[0] < t:
            heapq.heappop(a)
        if a:
            ab = a[0] if core is None else \
                a[0] + self._arrival_barrier_offset(core)
            if ab < bound:
                bound = ab
        return bound

    def run(self, tasks: list[Task]) -> "Scheduler":
        self.prime(tasks)
        return self.drain()

    # -- stepping interface ----------------------------------------------
    #
    # A cluster-level dispatcher interleaves N node schedulers: it primes
    # each node once, injects tasks as the front-end routes them, and
    # advances every node to the current cluster time with step().

    def prime(self, tasks: list[Task] = ()) -> "Scheduler":
        """Register initial arrivals and start timers without running."""
        # First prime: count pre-populated completed/failed (the microvm
        # admission path appends rejects before run()). Later primes:
        # ACCUMULATE, so injected in-flight tasks keep counting and
        # work_remaining() cannot go false mid-run.
        base = getattr(self, "total_tasks", None)
        if base is None:
            base = len(self.completed) + len(self.failed)
        self.total_tasks = base + len(tasks)
        for task in tasks:
            self._push(max(self.now, task.arrival), ARRIVAL, task)
        if not self._primed:
            self._primed = True
            if self.trace_util:
                self._push(self.util_sample_ms, TIMER, "util")
            if self.containers is not None and self.containers.cfg.sweep_ms:
                # Keep-alive reaper rides the same parked-timer machinery
                # as util sampling: it parks when the node drains and
                # revives with the next injected invocation.
                self._push(self.now + self.containers.cfg.sweep_ms, TIMER,
                           "keepalive")
            self.on_start()
        else:
            # A re-run (e.g. run() called again with more work): the
            # periodic timers parked when the first batch finished must
            # come back with the new work.
            self._revive_parked_timers(self.now)
        return self

    def _revive_parked_timers(self, at: float) -> None:
        for payload, interval in self._parked_timers.items():
            self._push(at + interval, TIMER, payload)
        self._parked_timers.clear()

    def inject(self, task: Task, t: Optional[float] = None) -> None:
        """Feed one task in at time ``t`` (>= now); used by cluster
        dispatch, where arrival times are decided by the front end. The
        arrival EVENT is clamped to now (the clock never rewinds); the
        task's ``arrival`` field keeps its original value so queueing
        delay is still measured from true arrival."""
        self.total_tasks = getattr(self, "total_tasks", 0) + 1
        ta = task.arrival if t is None else max(t, task.arrival)
        self._push(max(self.now, ta), ARRIVAL, task)
        self._revive_parked_timers(max(self.now, ta))

    def next_event_time(self) -> float:
        """Time of the earliest pending event (inf when drained).
        Tombstoned records may make this conservatively early, exactly
        as stale generation-counter events used to."""
        return self.heap[0][0] if self.heap else _INF

    def _pop_event(self) -> None:
        rec = heapq.heappop(self.heap)
        t = rec[0]
        kind = rec[3]
        payload = rec[4]
        rec[4] = None
        self._pool.append(rec)
        if kind == DEAD:
            return
        self.now = t
        if kind == ARRIVAL:
            self.n_events += 1
            self.on_arrival(payload, t)
        elif kind == CORE_EVT:
            payload.pending = None
            self._run_core(payload, t)
        else:  # TIMER
            self.n_events += 1
            self.on_timer(payload, t)

    def step(self, until: float) -> "Scheduler":
        """Process every event with timestamp <= ``until`` and advance
        the clock there, so snapshots taken by a dispatcher see node
        state as of the cluster-wide current time."""
        self._hz = until
        heap = self.heap
        while heap and heap[0][0] <= until:
            self._pop_event()
        self._hz = _INF
        self.now = max(self.now, until)
        return self

    def drain(self) -> "Scheduler":
        """Run the event loop to exhaustion."""
        self._hz = _INF
        heap = self.heap
        while heap:
            self._pop_event()
        # Completion batches can retire the tail of the run without any
        # heap traffic; land the clock where the last event-by-event
        # pop would have (end-of-run settle/stats read self.now).
        if self._ff_now > self.now:
            self.now = self._ff_now
        return self

    def shutdown(self, t: Optional[float] = None) -> "Scheduler":
        """Decommission this node at time ``t`` (>= now): the machine is
        gone, so the warm-pool memory meter must stop HERE — not keep
        (mis)counting until whenever a roll-up next settles the pool —
        and the parked periodic timers (keep-alive reaper, util
        sampling) must die with it instead of waiting for an inject that
        will never come. Idempotent; graceful removal drains first,
        chaos kills call it with work still in flight (the cluster layer
        requeues that work elsewhere)."""
        t = self.now if t is None else max(self.now, t)
        self.now = t
        self._parked_timers.clear()
        if self.containers is not None:
            # Bring the hold integral current, then destroy the idle
            # warm set: expired sandboxes stop metering at their expiry,
            # live ones at the decommission instant.
            self.containers.settle(self.now)
            self.containers.flush(self.now)
            # A dead machine holds no concurrency slots and owes its
            # queued slot waiters nothing — the cluster layer requeues
            # the waiting TASKS through the dispatcher; this clears the
            # pool-side accounting so invariants hold on the corpse.
            self.containers.drain_slots()
        return self

    def set_interference(self, fn) -> None:
        """Attach or adjust the interference function mid-run (SKU clock
        multipliers, chaos ``degrade`` events). Disables the analytic
        fast-forward ONE-WAY: barriers stop being maintained the moment
        interference appears, so re-enabling later would fast-forward
        over missing barrier state. Chunks already in flight keep their
        rate; the new rate applies from the next chunk start."""
        self.interference_fn = fn
        self._use_ff = False

    # -- load snapshot (cluster dispatch) ---------------------------------
    def n_running(self) -> int:
        return sum(1 for c in self.cores if c.task is not None)

    def global_queue_len(self) -> int:
        """Length of the policy's centralized queue, if it keeps one.
        Policies with a global queue MUST override this or heartbeat
        load reports undercount and state-aware dispatch misroutes."""
        return 0

    def n_queued(self) -> int:
        """Tasks admitted but not currently on a core: per-core
        runqueues plus the policy's global queue."""
        return sum(len(c.rq) for c in self.cores) + self.global_queue_len()

    def has_idle_core(self) -> bool:
        return self.idle_core() is not None

    def load_snapshot(self) -> dict:
        """Instantaneous occupancy — what a least-loaded or pull-based
        front end would learn from a node heartbeat. With a container
        pool attached the heartbeat also carries the warm-set contents,
        which warm-aware and cost-aware dispatchers route on."""
        running, queued = self.n_running(), self.n_queued()
        snap = {
            "running": running,
            "queued": queued,
            "load": (running + queued) / self.n_cores,
            # A rightsizer-locked core cannot start work, so it does not
            # make the node "idle" to a pull-based dispatcher.
            "idle": queued == 0 and self.has_idle_core(),
        }
        if self.containers is not None:
            # Heartbeats are taken per routing decision: a read-only
            # live view, never a pool mutation, on the dispatch hot
            # path (expired-but-unswept sandboxes are excluded).
            warm, warm_mb = self.containers.live_view(self.now)
            snap["warm"] = warm
            snap["warm_mb"] = warm_mb
            # Advertise this node's configured cold-start model so a
            # cost-aware front end prices cold routes with the ACTUAL
            # penalty, not module defaults.
            snap["cold_model"] = (self.containers.cfg.cold_base_ms,
                                  self.containers.cfg.cold_per_gb_ms)
        return snap

    # -- chunk lifecycle -------------------------------------------------
    def _start_chunk(self, core: Core, task: Task, t: float,
                     limit: Optional[float] = None) -> float:
        """Install ``task`` on ``core`` and return the chunk's expiry
        instant. The caller schedules the expiry: dispatch() pushes a
        heap record; the event loop may instead process it inline."""
        ctx = self.ctx_switch_ms if core.last_task is not task else 0.0
        if task.first_run is None:
            task.first_run = t
            if self.containers is not None and task.aux_of is None:
                # Cold/warm path decided the instant the invocation first
                # claims a core: a miss occupies the core for init_ms of
                # sandbox boot before useful work — wall-clock execution
                # (what the provider bills) includes it.
                if not self.containers.acquire(task.func_id, task.mem_mb, t):
                    task.cold_start = True
                    task.init_ms = self.containers.cold_start_ms(task.mem_mb)
                    task.remaining += task.init_ms
        run = chunk_run_ms(task.remaining, limit)
        rate = 1.0
        if self.interference_fn is not None:
            rate = max(0.05, 1.0 - self.interference_fn(t))
        core.task = task
        core.chunk_start = t
        core.chunk_work_start = t + ctx
        core.chunk_len = run
        core.chunk_rate = rate
        if ctx > 0.0:
            task.ctx_switches += 1
            self.total_ctx += 1
        return chunk_end_ms(t, ctx, run / rate)

    def _complete(self, task: Task, t: float) -> None:
        """Single completion path: record, return the sandbox to the
        warm pool, and fire the policy hook. The pool release is
        DEFERRED (buffered keyed (t, func_id, tid)) so event-path and
        batch-path completions share one canonical ordering; the pool
        applies it before its next read at/after ``t``."""
        task.remaining = 0.0
        task.completion = t
        if self.containers is not None and task.aux_of is None:
            self.containers.release_at(task.func_id, task.mem_mb, t,
                                       task.tid)
        self.completed.append(task)
        self.on_complete(task, t)

    def _retire_completion(self, core: Core, e: float) -> None:
        """Batch-path twin of the event loop's completion processing:
        the same float operations and hook order as `_run_core` +
        `_complete`, minus the heap record. Pool releases and adapter
        observations buffer and re-serialize canonically, so retiring
        completions per core (possibly out of global time order across
        cores) leaves every observable exactly as the heap path would
        (DESIGN.md Sec. 13)."""
        task = core.task
        task.remaining -= core.chunk_len
        task.cpu_time += core.chunk_len
        core.busy_ms += e - core.chunk_start
        core.task = None
        core.last_task = task
        self._complete(task, e)
        self.n_events += 1
        if e > self._ff_now:
            self._ff_now = e

    def _interrupt(self, core: Core, t: float) -> Task:
        """Stop the running chunk early; returns the (partially run)
        task. The in-flight heap record is tombstoned in place and
        recycled when it surfaces (lazy deletion)."""
        task = core.task
        done = min(max(0.0, t - core.chunk_work_start) * core.chunk_rate,
                   core.chunk_len)
        task.remaining -= done
        task.cpu_time += done
        core.busy_ms += max(0.0, t - core.chunk_start)
        rec = core.pending
        if rec is not None:
            rec[3] = DEAD
            rec[4] = None
            core.pending = None
        core.task = None
        core.last_task = task
        if task.remaining <= _EPS:  # raced with completion
            self._complete(task, t)
        return task

    def _run_core(self, core: Core, t: float) -> None:
        """Process a chunk expiry, then keep advancing this core inline
        while its next expiry lands strictly before every other pending
        event and inside the step() horizon. Equivalent to the pop-push
        loop event by event — same hooks, same float operations, same
        tie-breaking (ties go through the heap) — minus the heap churn.
        """
        hz = self._hz
        heap = self.heap
        while True:
            self.n_events += 1
            task = core.task
            task.remaining -= core.chunk_len
            task.cpu_time += core.chunk_len
            core.busy_ms += t - core.chunk_start
            core.task = None
            core.last_task = task
            if task.remaining <= _EPS:
                self._complete(task, t)
            else:
                self.on_chunk_limit(core, task, t)
            if core.task is not None or t < core.locked_until:
                return
            pick = self.pick_next(core, t)
            if pick is None:
                return
            ntask, limit = pick
            end = self._start_chunk(core, ntask, t, limit)
            if self._use_ff:
                end = self.fast_forward(core, end, hz)
                if end is None:
                    # The batch retired the chain through its last
                    # completion and the core went idle — there is no
                    # in-flight chunk left to schedule.
                    return
            if end < (heap[0][0] if heap else _INF) and end <= hz:
                self.now = t = end
                continue
            self._push_core(core, end)
            return

    def fast_forward(self, core: Core, end: float, hz: float):
        """Analytic round fast-forward hook (DESIGN.md Sec. 13).

        Called with ``core`` mid-chunk (expiry at ``end``). A policy
        whose slice cycle is closed-form may retire any number of
        expiry rounds here with plain arithmetic — replicating the
        exact per-round float operations — and return the new in-flight
        chunk's expiry, or ``None`` when the batch retired the chain
        through its final completion and left the core idle. Rounds may
        cross OTHER cores' pending chunk expiries (pure slice expiries
        touch only their own core) but must stop strictly before the
        next interacting event (:meth:`_next_barrier`) and at or before
        the ``hz`` horizon.

        Completions NO LONGER bound a batch (``_batch_complete``):
        their shared-state effects travel through order-canonical
        channels — the pool's deferred-release buffer, the adapter's
        buffered observations, the sorted/fsum roll-ups — and
        re-serialize by (time, tie-key) at the next read. The one
        shared effect with no such channel is a first dispatch's pool
        acquire (hit/miss feeds timing; a miss draws the cold-start
        RNG), so with a container pool attached a fresh task's pick
        still stops the batch; without one, first dispatches batch and
        only stamp ``first_run``. Must leave ALL observable state
        (task metrics, runqueue contents and seq numbers, min_vruntime,
        busy accounting) exactly as the event-by-event path would."""
        return end

    def dispatch(self, core: Core, t: float) -> None:
        if core.task is not None or t < core.locked_until:
            return
        pick = self.pick_next(core, t)
        if pick is not None:
            task, limit = pick
            end = self._start_chunk(core, task, t, limit)
            self._push_core(core, end)

    def kick(self, core: Core, t: float) -> None:
        if core.task is None:
            self.dispatch(core, t)

    def idle_core(self, cores: Optional[list[Core]] = None) -> Optional[Core]:
        for core in cores if cores is not None else self.cores:
            if core.task is None and self.now >= core.locked_until:
                return core
        return None

    # -- utilization sampling ---------------------------------------------
    def sample_util(self, t: float) -> dict:
        groups: dict[int, list[float]] = {}
        for core in self.cores:
            total = core.busy_total(t)
            delta = total - core.busy_snapshot
            core.busy_snapshot = total
            groups.setdefault(core.group, []).append(delta)
        window = self.util_sample_ms
        return {g: sum(v) / (len(v) * window) for g, v in groups.items() if v}

    def work_remaining(self) -> bool:
        """True while any task is incomplete. Periodic timers must key
        off THIS, not heap emptiness — two timers would otherwise keep
        each other alive forever."""
        done = len(self.completed) + len(self.failed)
        return done < getattr(self, "total_tasks", 0)

    def _reschedule_timer(self, payload, interval: float) -> None:
        """Keep a periodic timer alive while work remains; otherwise PARK
        it so a later ``inject`` revives it. A cluster node is often
        momentarily quiescent between dispatched invocations — letting
        the timer chain die there would silently disable util tracing /
        rightsizing for the rest of the run."""
        if self.work_remaining():
            self._push(self.now + interval, TIMER, payload)
        else:
            self._parked_timers[payload] = interval

    def on_timer(self, payload, t: float) -> None:
        if payload == "util":
            util = self.sample_util(t)
            self.util_series.append(
                (t, util, sum(1 for c in self.cores if c.group == GROUP_FIFO)))
            self._reschedule_timer("util", self.util_sample_ms)
        elif payload == "keepalive":
            self.containers.evict_expired(t)
            self._reschedule_timer("keepalive", self.containers.cfg.sweep_ms)

    # -- policy hooks -------------------------------------------------------
    def on_start(self) -> None:  # pragma: no cover - trivial
        pass

    def on_arrival(self, task: Task, t: float) -> None:
        raise NotImplementedError

    def pick_next(self, core: Core, t: float):
        raise NotImplementedError

    def on_chunk_limit(self, core: Core, task: Task, t: float) -> None:
        raise NotImplementedError

    def on_complete(self, task: Task, t: float) -> None:
        pass


def cfs_fast_forward(sched: Scheduler, core: Core, end: float, hz: float):
    """Shared precondition gate for CFS-style slice cycles, used by both
    the pure-CFS policy and the hybrid CFS group (the scheduler must
    expose ``sched_latency_ms`` / ``min_granularity_ms``). Validates
    that the in-flight chunk is a full slice of the constant quantum —
    or the task's FINAL (completing) chunk, which enters the chain
    driver directly — honours ``_ff_solo_only``, and requires a barrier
    window wide enough to batch at least one round before entering the
    round engine."""
    if sched.interference_fn is not None:
        return end
    rq = core.rq
    if rq and sched._ff_solo_only:
        return end
    task = core.task
    nr = len(rq)
    s = max(sched.sched_latency_ms / (nr if nr else 1),
            sched.min_granularity_ms)
    if core.chunk_len != s:
        # Not a full slice: the only other chunk CFS starts is the
        # task's final partial chunk (run == remaining < s). Retire
        # the completion chain from it when batching is on.
        if not (sched._batch_complete
                and chunk_completes(task.remaining, core.chunk_len)):
            return end
    elif not chunk_completes(task.remaining, s):
        bound = sched._next_barrier(core.chunk_start, core)
        if bound - end < s:
            return end               # window too short to batch a round
        return _cfs_chain(sched, core, end, bound, hz, s)
    elif not sched._batch_complete:
        return end                   # full-slice chunk that completes
    bound = sched._next_barrier(core.chunk_start, core)
    return _cfs_chain(sched, core, end, bound, hz, s)


def _cfs_chain(sched: Scheduler, core: Core, end: float, bound: float,
               hz: float, s: float):
    """Chain driver: alternate the closed-form slice-round engine with
    analytic completion retirement until an interacting event, the
    ``hz`` horizon, or a pick the batch may not perform (a fresh task's
    first dispatch with a container pool attached).

    Completion retirement replicates the event path exactly: retire the
    final chunk, `_complete` (deferred pool release, completed append,
    policy hook), then `pick_next` — pop the runqueue minimum, advance
    ``min_vruntime``, recompute the slice for the shrunk queue, charge
    the context switch, stamp ``first_run`` on a fresh pick (legal only
    with no pool — the gate in the loop guarantees it) — and start the
    next chunk with the same float expression `_start_chunk` uses.
    Returns the new in-flight chunk's expiry, or None when the chain
    drained the runqueue and the core went idle."""
    eps = _EPS
    batch_complete = sched._batch_complete
    pool = sched.containers
    lat = sched.sched_latency_ms
    gran = sched.min_granularity_ms
    ctx_ms = sched.ctx_switch_ms
    while True:
        task = core.task
        if task.remaining - core.chunk_len > eps:
            # Full-slice regime (chunk_len == s here by construction).
            end = cfs_round_fast_forward(sched, core, end, bound, hz, s)
            task = core.task         # the batch may have rotated tasks
            if task.remaining - core.chunk_len > eps:
                return end           # stopped at bound/hz/serialized pick
        # The in-flight chunk completes its task at `end`.
        if not (end < bound and end <= hz) or not batch_complete:
            return end               # engine path processes the expiry
        rq = core.rq
        if rq and pool is not None and rq[0][2].first_run is None:
            return end               # next pick serializes (pool + RNG)
        sched._retire_completion(core, end)
        if end < core.locked_until:
            return None              # rightsizer lock: timer dispatches
        if not rq:
            return None              # queue drained: core idles at `end`
        # -- pick_next, replicated -----------------------------------
        vr, _seq, ntask = rq.pop(0)
        if vr > core.min_vruntime:
            core.min_vruntime = vr
        nr = len(rq)
        s = max(lat / (nr if nr else 1), gran)
        ctx = ctx_ms if core.last_task is not ntask else 0.0
        if ntask.first_run is None:
            ntask.first_run = end    # no pool here: purely core-local
        rem = ntask.remaining
        run = rem if rem < s else s
        if run < eps:
            run = eps
        core.task = ntask
        core.chunk_start = end
        core.chunk_work_start = end + ctx
        core.chunk_len = run
        core.chunk_rate = 1.0
        if ctx > 0.0:
            ntask.ctx_switches += 1
            sched.total_ctx += 1
        end = (end + ctx) + run      # same ops as _start_chunk, rate 1


def cfs_round_fast_forward(sched: Scheduler, core: Core, end: float,
                           bound: float, hz: float, s: float) -> float:
    """Retire successive CFS slice-expiry rounds on one core analytically.

    Preconditions (checked by the calling policy): no interference model
    (chunk rate is exactly 1.0), the in-flight chunk is a full slice of
    length ``s``, and the policy's slice-expiry bookkeeping for this
    core is exactly the base CFS sequence (vruntime += slice, preemption
    counters, runqueue re-insert). While the runqueue membership is
    stable — every event that could change it lands at or after
    ``bound`` (the next interacting event) or past the ``hz`` horizon —
    the heap-mediated cycle

        expire -> vruntime += s -> rq_push -> rq_pop(min) -> next slice

    is a closed form over a small sorted list. Every float operation the
    event path would perform is replicated in the same order, so the
    result is bit-identical (tests/test_engine_equivalence.py); the
    runqueue is left as a sorted list, which is a valid heap with the
    exact (vruntime, seq) entries the push/pop sequence would produce.

    Returns the new in-flight chunk's expiry instant.
    """
    task = core.task
    rq = core.rq                     # kept sorted: spliced in place
    if not rq:
        return _solo_fast_forward(sched, core, task, end, bound, hz, s)
    # Long stable alternation cycles (every task gets one slice per
    # round, queue order fixed) are closed-form too: batch them with
    # vectorized exact accumulation, then let the engine re-enter for
    # whatever regime follows.
    lim = bound if bound <= hz else hz + 1.0
    if (lim - end) / (sched.ctx_switch_ms + s) >= 96.0:
        res = _cycle_fast_forward(sched, core, task, end, bound, hz, s, lim)
        if res is not None:
            return res
    t = core.chunk_start
    e = end
    ws = core.chunk_work_start
    cur_run = core.chunk_len         # == s
    busy = core.busy_ms
    mv = core.min_vruntime
    rq_seq = core.rq_seq
    ctx_ms = sched.ctx_switch_ms
    charge_ctx = ctx_ms > 0.0
    no_pool = sched.containers is None
    eps = _EPS
    last = core.last_task
    ctx_n = 0
    n = 0
    rq_pop = rq.pop
    while True:
        if not (e < bound and e <= hz):
            break                    # an interacting event intervenes
        nrem = task.remaining - s
        if nrem <= eps:
            break                    # chunk completes; the chain driver
            # (or the engine path, when batching is off) handles it
        vr = task.vruntime + s
        head = rq[0]
        if head[0] <= vr:
            ntask = head[2]
            if ntask.first_run is None:
                if not no_pool:
                    # The pick would be this task's FIRST dispatch:
                    # with a pool that path acquires a sandbox (and on
                    # a miss draws the cold-start RNG), which must
                    # interleave with other cores' pool operations in
                    # exact heap order.
                    break
                # No pool: a first dispatch only stamps first_run with
                # the new chunk's start instant — purely core-local.
                ntask.first_run = e
            # -- slice expiry at e: retire the in-flight chunk --------
            task.remaining = nrem
            task.cpu_time += s
            busy += e - t
            task.vruntime = vr
            task.preemptions += 1
            seq = rq_seq
            rq_seq = seq + 1         # the rq_push the event path would do
            # -- rq_pop: the fresh (vr, seq) entry loses ties ---------
            rq_pop(0)
            insort(rq, (vr, seq, task))
            hv = head[0]
            if hv > mv:
                mv = hv
            last = task
            task = ntask
            rem = task.remaining
            run = rem if rem < s else s
            if run < eps:
                run = eps
            if charge_ctx:
                task.ctx_switches += 1
                ctx_n += 1
            t = e
            ws = t + ctx_ms
            e = ws + run             # == t + ctx + run / 1.0, bit-exact
        else:
            # Catch-up: the running task stays ahead of the queue and
            # keeps the core (no context switch).
            task.remaining = nrem
            task.cpu_time += s
            busy += e - t
            task.vruntime = vr
            task.preemptions += 1
            rq_seq += 1
            if vr > mv:
                mv = vr
            last = task
            run = nrem if nrem < s else s
            if run < eps:
                run = eps
            t = e
            e = t + run              # ctx == 0.0: t + 0.0 + run / 1.0
            ws = t
        cur_run = run
        n += 1
        if run != s:
            break                    # final partial chunk is in flight
    if n:
        core.task = task
        core.last_task = last
        core.chunk_start = t
        core.chunk_work_start = ws
        core.chunk_len = cur_run
        core.busy_ms = busy
        core.min_vruntime = mv
        core.rq_seq = rq_seq
        core.preempt_count += n
        sched.total_ctx += ctx_n
        sched.n_events += n
        return e
    return end


# Windowed sub-round batching: queues deeper than _WINDOW_MIN use the
# completion-aware windowed pass (setup O(window), completions retired
# inline) instead of the full-queue cycle engine; windows evaluate 64
# chunks first and escalate to _WINDOW when the whole window retires.
_WINDOW_MIN = 256
_WINDOW = 256


def _window_fast_forward(sched: Scheduler, core: Core, task: Task,
                         end: float, bound: float, hz: float, s: float):
    """Sub-round vectorized batch — COMPLETIONS INCLUDED — over the
    first ``_WINDOW`` picks of a DEEP runqueue.

    Chunk i runs the i-th task of the rotation ([running] ++ queue
    order): within one rotation every pick is distinct, so per-task
    state needs no accumulation — one elementwise add/subtract
    reproduces the event path's single float operation per task
    exactly. Chunk lengths are ``min(remaining, s)``: a COMPLETING
    chunk simply runs short, retires its task analytically (deferred
    pool release, completed append, ``on_complete`` hook) and pushes
    nothing back, while every other chunk is a full slice that pushes
    ``vruntime + s`` at the tail. The chunk-end chain stays one exact
    interleaved ``accumulate`` over (+ctx, +run_i), so the whole braid
    — slices, completions, next picks — is evaluated in a handful of
    O(window) array ops. This is what retires dense-queue completion
    RUNS without per-event heap traffic (DESIGN.md Sec. 13).

    Stops (exact, per chunk, on the accumulated values): an
    interacting event at/after ``bound``; the ``hz`` horizon; a
    non-completing push that would not land at the queue tail (the
    same stability condition as the full-cycle engine); a pick whose
    first dispatch must serialize (fresh task + container pool); the
    slice leaving the constant-quantum regime (enough completions that
    ``latency / nr > min_granularity``); any completion when the
    policy opted out of completion batching. Returns the new in-flight
    expiry, or ``None`` to decline to the scalar/driver path. A fully
    retired window hands back to the chain driver, which re-enters —
    stable stretches advance window by window at O(1) amortized setup
    per chunk."""
    rq = core.rq
    no_pool = sched.containers is None
    if not no_pool and rq[0][2].first_run is None:
        return None                  # head pick is a serialized first
        # dispatch: don't pay the window setup to learn c == 0
    if end < core.locked_until:      # rightsizer lock pending: rare,
        return None                  # let the event path sort it out
    k1 = len(rq)
    lat = sched.sched_latency_ms
    gran = sched.min_granularity_ms
    # Adaptive sizing: evaluation is pure until the commit, so a too-
    # small window just costs one extra pass. Start from this core's
    # last batch length (completion cadence is locally stable) and
    # escalate to full width when the whole window retires.
    wmax = min(_WINDOW, k1 - 1)
    W = min(64, wmax) if core.ff_w < 56 else wmax
    while True:
        c, arrays = _window_eval(sched, core, task, end, bound, hz, s,
                                 W, k1, lat, gran, no_pool)
        if c >= W and W < wmax:
            W = wmax                   # whole window retired: go wide
            continue
        break
    core.ff_w = c
    tasks_w, cum = arrays[0], arrays[7]
    if c >= 2 and (
            (not no_pool and tasks_w[c].first_run is None)
            or (sched._batch_complete
                and lat / (k1 - int(cum[c - 1])) > gran)):
        # The stop is the pick of chunk c itself (a serialized first
        # dispatch, or a slice that would no longer be s): the batch
        # may not START that chunk either — leave the previous chunk
        # in flight, like the scalar loop's break-before-pick.
        c -= 1
    if c < 2:
        return None
    return _window_commit(sched, core, task, end, s, c, arrays, no_pool)


def _window_eval(sched, core, task, end, bound, hz, s, W, k1, lat, gran,
                 no_pool):
    """Pure evaluation half of the windowed pass: how many chunks of
    the rotation can retire, and the exact value arrays the commit
    needs. Mutates nothing."""
    rq = core.rq
    eps = _EPS
    ctx_ms = sched.ctx_switch_ms
    tasks_w = [task] + [rq[i][2] for i in range(W)]
    rem0 = np.array([x.remaining for x in tasks_w])          # W + 1
    vr0 = np.array([x.vruntime for x in tasks_w[:W]])
    pushed = vr0 + s                 # one add per task, same op as the loop
    rem_after = rem0[:W] - s
    completing = rem_after <= eps    # full-slice finishers AND short rests
    runs = np.minimum(rem0, s)       # chunk i's length = min(rem_i, s)
    buf = np.empty(2 * W + 1)
    buf[0] = end                     # chunk 0 (in flight) ends at `end`
    buf[1::2] = ctx_ms
    buf[2::2] = runs[1:]             # e_i = e_{i-1} + ctx + run_i
    half = np.add.accumulate(buf)    # exact interleaved (+ctx, +run) chain
    ends = half[0::2]                # e_0 .. e_W
    ok = (ends[:W] < bound) & (ends[:W] <= hz)
    cum = np.add.accumulate(completing)   # completions among chunks 0..i
    if sched._batch_complete:
        # Slice constancy: completions shrink the queue, and chunk i's
        # pick granted slice s only while latency/nr <= min_granularity
        # (the exact comparison slice_for flips on). nr at chunk i's
        # pick counts completions strictly before chunk i.
        slice_ok = np.empty(W, dtype=bool)
        slice_ok[0] = True           # chunk 0 started before the batch
        np.less_equal(lat / (k1 - cum[:-1]), gran, out=slice_ok[1:])
        ok &= slice_ok
    else:
        ok &= ~completing            # completions serialize (opt-out)
    # Stability: every NON-completing push must land at the queue tail
    # (>= the running max of the original tail and every prior push).
    pushed_eff = np.where(completing, -_INF, pushed)
    prior = np.empty(W)
    prior[0] = rq[-1][0]
    np.maximum.accumulate(pushed_eff[:-1], out=prior[1:])
    np.maximum(prior[1:], rq[-1][0], out=prior[1:])
    ok &= completing | (pushed >= prior)
    if not no_pool:
        # A fresh task's first dispatch acquires a sandbox (and may
        # draw the cold-start RNG): chunk i may not PICK a fresh task.
        ok &= np.fromiter((x.first_run is not None
                           for x in tasks_w[:W]), bool, W)
    c = int(np.argmin(ok)) if not ok.all() else W
    return c, (tasks_w, rem_after, completing, runs, pushed, ends, half,
               cum)


def _window_commit(sched, core, task, end, s, c, arrays, no_pool):
    """Commit half of the windowed pass: apply ``c`` retired chunks and
    start chunk ``c``. Bulk-converts the value arrays once (per-element
    numpy indexing + float() is the single largest cost of the whole
    pass at this batch size)."""
    tasks_w, rem_after, completing, runs, pushed, ends, half, cum = arrays
    rq = core.rq
    eps = _EPS
    ctx_ms = sched.ctx_switch_ms
    charge_ctx = ctx_ms > 0.0
    seq0 = core.rq_seq
    comp_l = completing[:c].tolist()
    rem_l = rem_after[:c].tolist()
    run_l = runs[:c + 1].tolist()
    push_l = pushed[:c].tolist()
    ends_l = ends[:c].tolist()
    pool = sched.containers
    completed = sched.completed
    if no_pool:
        # Stamp BEFORE the retirement loop: a fresh task may complete
        # in its very first chunk, and on_complete hooks read
        # execution = completion - first_run.
        for j in range(1, c + 1):    # in-flight pick included
            x = tasks_w[j]
            if x.first_run is None:
                x.first_run = ends_l[j - 1]   # chunk j starts at e_{j-1}
    npush = 0
    ff_now = sched._ff_now
    for j in range(c):
        x = tasks_w[j]
        if comp_l[j]:
            e = ends_l[j]
            x.cpu_time = x.cpu_time + run_l[j]
            x.remaining = 0.0
            x.completion = e
            if pool is not None and x.aux_of is None:
                pool.release_at(x.func_id, x.mem_mb, e, x.tid)
            completed.append(x)
            sched.on_complete(x, e)
            if e > ff_now:
                ff_now = e
        else:
            x.remaining = rem_l[j]
            x.vruntime = push_l[j]
            x.cpu_time = x.cpu_time + s
            x.preemptions += 1
            npush += 1
        if charge_ctx and j:         # chunk j (j>=1) starts with a switch
            x.ctx_switches += 1
            sched.total_ctx += 1
    sched._ff_now = ff_now
    nxt_task = tasks_w[c]
    if charge_ctx:
        nxt_task.ctx_switches += 1   # the in-flight chunk's switch
        sched.total_ctx += 1
    # survivors: original entries c.. plus the non-completing pushes,
    # in chunk order (each lands at the tail: checked above)
    tail = []
    seq = seq0
    for i in range(c):
        if not comp_l[i]:
            tail.append((push_l[i], seq, tasks_w[i]))
            seq += 1
    core.rq = rq[c:] + tail
    mv = rq[c - 1][0]                # last popped (original) entry
    if mv > core.min_vruntime:
        core.min_vruntime = mv
    core.rq_seq = seq
    core.preempt_count += npush
    sched.n_events += c
    d = np.empty(c)
    d[0] = end - core.chunk_start
    if c > 1:
        np.subtract(ends[1:c], ends[0:c - 1], out=d[1:])
    acc = np.empty(c + 1)
    acc[0] = core.busy_ms
    acc[1:] = d
    core.busy_ms = float(np.add.accumulate(acc)[-1])
    run = run_l[c]
    ws = float(half[2 * c - 1])      # t + ctx, exact
    e = float(ends[c])
    if run < eps:                    # unreachable for queued tasks
        run = eps                    # (remaining > eps), kept for parity
        e = ws + run
    core.task = nxt_task
    core.last_task = tasks_w[c - 1]
    core.chunk_start = ends_l[c - 1]
    core.chunk_work_start = ws
    core.chunk_len = run
    return e


def _cycle_fast_forward(sched: Scheduler, core: Core, task: Task,
                        end: float, bound: float, hz: float, s: float,
                        lim: float):
    """Vectorized stable-cycle batch: ``k`` tasks alternating, one full
    slice each per round, queue order fixed.

    In the stable regime the pushed-vruntime sequence is nondecreasing,
    so every ``insort`` lands at the queue tail and every pick takes the
    head — the whole braid is determined by per-task accumulation
    sequences. Those are single-operand float chains (``vr += s``,
    ``rem -= s``, ``e += ctx; e += s``), which ``ufunc.accumulate``
    reproduces bit-exactly at C speed. The stability condition itself is
    checked ON the exact accumulated values, so the batch stops at the
    precise chunk where the event path would first deviate (catch-up,
    completion, barrier, partial slice, queue reorder) and hands back;
    the scalar loops take over from identical state.

    Returns the new in-flight chunk expiry, or None to decline (the
    caller falls through to the scalar loop).
    """
    rq = core.rq
    k1 = len(rq)                     # waiting tasks (k = k1 + 1)
    k = k1 + 1
    # Cheap necessary condition for cycle stability (in exact arithmetic
    # gaps between vruntimes are cycle-invariant, so round one decides):
    # the running task must re-queue at the tail and behind the head.
    vr0 = task.vruntime
    if vr0 + s < rq[-1][0] or vr0 > rq[0][0]:
        return None
    if k1 > _WINDOW_MIN:
        # Deep queue: a batch usually stops well before one full
        # rotation (a completion, or instability), so the full-queue
        # O(k) setup below would swamp its own yield. The windowed
        # sub-round pass keeps setup O(window) and retires completions
        # inline; genuinely stable long cycles just retire window
        # after window through the driver.
        return _window_fast_forward(sched, core, task, end, bound, hz, s)
    fresh = []
    if sched.containers is None:
        # First dispatches are core-local without a pool: stamp them at
        # commit with their first chunk's start (task j's first chunk
        # is chunk j). Sub-round commits (c < k) are routine, so only
        # tasks whose first chunk actually ran (j <= c) get stamped.
        fresh = [j for j, ent in enumerate(rq, start=1)
                 if ent[2].first_run is None]
    else:
        for ent in rq:
            if ent[2].first_run is None:
                return None          # first dispatches go through the heap
    ctx_ms = sched.ctx_switch_ms
    eps = _EPS
    tasks = [task] + [ent[2] for ent in rq]   # cycle (pick) order
    rem0 = [x.remaining for x in tasks]
    # Cycle cap: the tightest task's remaining, and the time to bound.
    min_rem = min(rem0)
    r_cap = int(min((min_rem - s) / s + 2.0,
                    (lim - end) / (k * (ctx_ms + s)) + 2.0)) + 1
    if r_cap * k < 96:
        return None                  # too short to be worth the arrays
    r_cap = min(r_cap, max(2, (1 << 20) // k))
    # Allocate for a modest horizon first and escalate geometrically
    # only when the whole window retires — stability or a barrier
    # usually stops a batch long before the remaining-time cap.
    r_try = min(r_cap, max(2, 768 // k))
    while True:
        c_max = r_try * k
        # -- exact per-task accumulation sequences --------------------
        m = np.full((k, r_try + 1), s)
        m[:, 0] = rem0
        rem_arr = np.subtract.accumulate(m, axis=1)
        m[:, 0] = [x.vruntime for x in tasks]
        vr_arr = np.add.accumulate(m, axis=1)
        # Chunk-end chain: e_{c+1} = (e_c + ctx) + s — two rounding
        # steps, interleaved in one accumulate so every intermediate
        # is exact.
        buf = np.empty(2 * c_max + 1)
        buf[0] = end
        buf[1::2] = ctx_ms
        buf[2::2] = s
        half = np.add.accumulate(buf)
        ends = half[0::2]            # e_c, len c_max + 1
        # -- how many chunks can be retired? --------------------------
        pushed = vr_arr[:, 1:].T.ravel()          # vr pushed at chunk c
        rem_after = rem_arr[:, 1:].T.ravel()      # remaining after chunk c
        ok = (ends[:c_max] < bound) & (ends[:c_max] <= hz) \
            & (rem_after > eps)
        # Stability: each push must land at the queue tail
        # (nondecreasing pushed sequence, from the queue maximum up).
        stab = np.empty(c_max, dtype=bool)
        stab[0] = pushed[0] >= rq[-1][0]
        np.greater_equal(pushed[1:], pushed[:-1], out=stab[1:])
        ok &= stab
        c_stop = int(np.argmin(ok)) if not ok.all() else c_max
        if c_stop < c_max or r_try >= r_cap:
            break
        r_try = min(r_cap, r_try * 8)
    if c_stop < 2:                   # nothing worth committing: scalar
        return None
    c = c_stop
    m[:, 0] = [x.cpu_time for x in tasks]
    cpu_arr = np.add.accumulate(m, axis=1)
    # -- commit: per-task state ---------------------------------------
    charge_ctx = ctx_ms > 0.0
    seq0 = core.rq_seq
    for j in fresh:
        if j <= c:                   # task j's first chunk (index j) ran
            tasks[j].first_run = float(ends[j - 1])
    # A sub-round batch (c < k: a completion stopped the rotation)
    # leaves tasks beyond index c untouched — skip their no-op writes;
    # this loop is the vectorizer's main Python cost in deep queues.
    ck, cr = c // k, c % k
    for j in range(c + 1 if c < k else k):
        x = tasks[j]
        runs = ck + (1 if j < cr else 0)            # chunks j, j+k, ... < c
        if runs:
            x.remaining = float(rem_arr[j, runs])
            x.vruntime = float(vr_arr[j, runs])
            x.cpu_time = float(cpu_arr[j, runs])
            x.preemptions += runs
        if charge_ctx:
            # batch-started chunks (1..c, in-flight included) with a
            # context switch, i.e. chunk indices congruent to j
            starts = ck if j == 0 else (c - j) // k + 1
            if starts:
                x.ctx_switches += starts
                sched.total_ctx += starts
    # busy: same (e_c - t_c) subtraction/addition sequence as the loop.
    d = np.empty(c)
    d[0] = end - core.chunk_start
    if c > 1:
        np.subtract(ends[1:c], ends[0:c - 1], out=d[1:])
    acc = np.empty(c + 1)
    acc[0] = core.busy_ms
    acc[1:] = d
    core.busy_ms = float(np.add.accumulate(acc)[-1])
    # queue: entries C..C+k-2 of (original ++ pushed) survive. A batch
    # shorter than one full round (a completion stops it mid-rotation)
    # keeps a suffix of the ORIGINAL entries — their tuples are reused
    # untouched — ahead of the freshly pushed tail.
    core.rq = rq[c:] + [(float(pushed[i]), seq0 + i, tasks[i % k])
                        for i in range(c - k1 if c > k1 else 0, c)]
    nxt_task = tasks[c % k]          # the chunk-c pick
    # last popped value = (original ++ pushed)[c-1] (pops nondecreasing)
    mv = float(pushed[c - k]) if c >= k else rq[c - 1][0]
    if mv > core.min_vruntime:
        core.min_vruntime = mv
    core.rq_seq = seq0 + c
    core.preempt_count += c
    sched.n_events += c
    # -- in-flight chunk c --------------------------------------------
    rem = nxt_task.remaining
    run = rem if rem < s else s
    if run < eps:
        run = eps
    t = float(ends[c - 1])
    ws = float(half[2 * c - 1])      # t + ctx, exact
    e = float(half[2 * c]) if run == s else ws + run
    core.task = nxt_task
    core.last_task = tasks[(c - 1) % k]
    core.chunk_start = t
    core.chunk_work_start = ws
    core.chunk_len = run
    return e


def _solo_scalar(sched: Scheduler, core: Core, task: Task, end: float,
                 bound: float, hz: float, s: float) -> float:
    """Scalar lone-task round chain — the short-batch counterpart of
    :func:`_solo_fast_forward`, same exact operations."""
    eps = _EPS
    t = core.chunk_start
    e = end
    busy = core.busy_ms
    n = 0
    run = s
    while e < bound and e <= hz:
        nrem = task.remaining - s
        if nrem <= eps:
            break
        task.remaining = nrem
        task.cpu_time += s
        busy += e - t
        task.vruntime += s
        task.preemptions += 1
        n += 1
        run = nrem if nrem < s else s
        if run < eps:
            run = eps
        t = e
        e = t + run
        if run != s:
            break
    if n:
        core.last_task = task
        core.chunk_start = t
        core.chunk_work_start = t
        core.chunk_len = run
        core.busy_ms = busy
        vr = task.vruntime
        if vr > core.min_vruntime:
            core.min_vruntime = vr
        core.rq_seq += n
        core.preempt_count += n
        sched.n_events += n
        return e
    return end


def _solo_fast_forward(sched: Scheduler, core: Core, task: Task, end: float,
                       bound: float, hz: float, s: float) -> float:
    """Vectorized lone-task round chain (empty runqueue, zero context
    switches). The per-round float updates are single-operand
    accumulations — ``remaining -= s``, ``vruntime += s``,
    ``cpu_time += s``, ``e += s`` — and ``numpy``'s ``ufunc.accumulate``
    applies its operator strictly sequentially in float64, so the
    accumulated sequences are bit-identical to the scalar loop while
    running at C speed. Stopping conditions are evaluated on the exact
    accumulated arrays; the final (possibly partial) chunk is started
    scalar, exactly like the general loop."""
    eps = _EPS
    rem0 = task.remaining
    # Upper bound on retirable full-slice rounds: remaining must stay
    # > s + eps after each, and each round pushes e forward by s past
    # the current chunk's end. Cap by the time budget (and absolutely)
    # so a year-long lone task against a far barrier does not allocate
    # gigabytes; hitting the cap just hands back to the engine loop,
    # which re-enters the fast-forward on the next chunk.
    lim = bound if bound <= hz else hz + 1.0  # allocation cap only
    r_cap = int(max(0.0, min((rem0 - s) / s, (lim - end) / s + 2.0))) + 1
    if r_cap <= 1:
        return end
    if r_cap < 48:
        # ufunc/allocation overhead beats the scalar loop on short
        # chains (the arrival-phase common case); stay scalar there.
        return _solo_scalar(sched, core, task, end, bound, hz, s)
    if r_cap > (1 << 21):
        r_cap = 1 << 21
    buf = np.full(r_cap + 1, s)
    buf[0] = rem0
    rem_seq = np.subtract.accumulate(buf)      # rem_i after i rounds
    buf[0] = end
    e_seq = np.add.accumulate(buf)             # e_i: chunk end after i rounds
    # Round i (1-based) retires the chunk ending at e_{i-1}; it needs
    # e_{i-1} < bound, e_{i-1} <= hz, rem_{i-1} - s > eps, and the
    # PREVIOUS round's started chunk to have been a full slice
    # (rem_{i-1} >= s, implied by rem_{i-1} - s > eps).
    ok = (e_seq[:-1] < bound) & (e_seq[:-1] <= hz) & (rem_seq[:-1] - s > eps)
    bad = np.argmin(ok) if not ok.all() else len(ok)
    n = int(bad)
    if n <= 0:
        return end
    t = float(e_seq[n - 1])
    e = float(e_seq[n])
    rem = float(rem_seq[n])
    # busy accumulates (e_i - t_i) per retired chunk — identical
    # subtraction and addition sequence to the scalar loop.
    d = np.empty(n)
    d[0] = end - core.chunk_start
    if n > 1:
        d[1:] = e_seq[1:n] - e_seq[0:n - 1]
    busy = np.add.accumulate(np.concatenate(([core.busy_ms], d)))[-1]
    # vruntime/cpu_time: same accumulate trick, then write back finals.
    buf[0] = task.vruntime
    task.vruntime = vr = float(np.add.accumulate(buf[:n + 1])[-1])
    buf[0] = task.cpu_time
    task.cpu_time = float(np.add.accumulate(buf[:n + 1])[-1])
    task.remaining = rem
    task.preemptions += n
    # The final started chunk may be the task's last (partial) slice.
    run = rem if rem < s else s
    if run < eps:
        run = eps
    e = t + run if run != s else e   # same op the scalar loop performs
    core.task = task
    core.last_task = task
    core.chunk_start = t
    core.chunk_work_start = t
    core.chunk_len = run
    core.busy_ms = float(busy)
    if vr > core.min_vruntime:
        core.min_vruntime = vr
    core.rq_seq += n
    core.preempt_count += n
    sched.n_events += n
    return e
