"""The paper's hybrid two-group FIFO+CFS scheduler (own copy of
``repro.core.hybrid``): ``percentile``, ``TimeLimitAdapter``,
``Rightsizer`` and ``HybridScheduler``.

Cores are split into a FIFO group (a global queue; tasks run without
preemption until a time limit) and a CFS group (per-core vruntime
queues); a task that exceeds the limit is preempted and migrated round
robin onto the CFS cores (the paper's Fig. 7). ``Rightsizer`` moves one
core from the hot group to the cold one when their utilisations drift
apart (Fig. 8's Lock / Preempt / Migrate / Transition / Unlock).

``TimeLimitAdapter`` keeps the most recent ``window`` task durations and
sets the FIFO group's time limit to a percentile of them (the paper's
Sec. IV-B). The window is mirrored into an incrementally maintained
sorted list, so ``limit()`` interpolates a cached percentile without
sorting. Samples buffered with :meth:`observe` enter the window at the
next flush in canonical ``(t, tid)`` order.
"""
from __future__ import annotations

import heapq
from bisect import bisect_left, insort
from collections import deque
from typing import Optional

from .events import (_EPS, _INF, GROUP_CFS, GROUP_FIFO, Core, Scheduler,
                     Task, cfs_fast_forward, cfs_slice_ms, fifo_budget_ms)


def percentile(sorted_vals: list[float], pct: float) -> float:
    """Linear-interpolated percentile of a pre-sorted list."""
    if not sorted_vals:
        raise ValueError("empty window")
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    rank = (pct / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class TimeLimitAdapter:
    """Sliding window (most recent ``window`` durations) percentile limit.

    ``record_series=True`` retains the full ``(t, limit)`` trajectory.
    """

    def __init__(self, pct: float = 95.0, window: int = 100,
                 initial_ms: float = 1633.0, record_series: bool = False):
        self.pct = pct
        self.window: deque[float] = deque(maxlen=window)
        self.initial_ms = initial_ms
        self.record_series = record_series
        self.series: list[tuple[float, float]] = []
        self._sorted: list[float] = []
        self._cached: Optional[float] = None
        self._pending: list[tuple[float, int, float]] = []  # (t, tid, dur)

    def _apply(self, duration_ms: float, now: float) -> None:
        w = self.window
        if len(w) == w.maxlen:
            # deque(maxlen) is about to drop the oldest sample; drop its
            # mirror entry (bisect finds an equal value, which is all
            # the percentile cares about).
            del self._sorted[bisect_left(self._sorted, w[0])]
        w.append(duration_ms)
        insort(self._sorted, duration_ms)
        self._cached = None
        if self.record_series:
            self.series.append((now, self._limit_value()))

    def observe(self, duration_ms: float, now: float, tid: int) -> None:
        """Batch entry point: buffer one completion's duration; it
        enters the window at the next flush at/after ``now``."""
        heapq.heappush(self._pending, (now, tid, duration_ms))

    def flush(self, upto: Optional[float] = None) -> None:
        """Apply buffered samples with t <= ``upto`` (all, if None) in
        canonical (t, tid) order."""
        pending = self._pending
        while pending and (upto is None or pending[0][0] <= upto):
            t, _tid, dur = heapq.heappop(pending)
            self._apply(dur, t)

    def record(self, duration_ms: float, now: float) -> None:
        """Immediate-path record: flushes due buffered samples first so
        the window stays in canonical time order."""
        self.flush(now)
        self._apply(duration_ms, now)

    def _limit_value(self) -> float:
        if not self._sorted:
            return self.initial_ms
        if self._cached is None:
            self._cached = percentile(self._sorted, self.pct)
        return self._cached

    def limit(self, now: Optional[float] = None) -> float:
        self.flush(now)
        return self._limit_value()


class Rightsizer:
    """Utilization-driven core migration between the two groups."""

    def __init__(self, interval_ms: float = 1000.0, threshold: float = 0.15,
                 min_group: int = 1, lock_ms: float = 1.0):
        self.interval_ms = interval_ms
        self.threshold = threshold
        self.min_group = min_group
        self.lock_ms = lock_ms
        self.migrations: list[tuple[float, int, int]] = []  # (t, from, to)


class HybridScheduler(Scheduler):
    """FIFO+CFS two-group scheduler (the paper's design, Fig. 7/8)."""

    name = "hybrid"
    _has_ff = True
    # A FIFO-group chunk expiry can migrate its over-limit task into
    # any CFS core's runqueue (reading that core's min_vruntime), so
    # FIFO-group expiries are fast-forward barriers for the CFS group.
    _barrier_groups = frozenset({GROUP_FIFO})
    # Subclasses that override on_chunk_limit with extra bookkeeping
    # when a CFS-group slice expires with a NON-empty runqueue (e.g. the
    # serving gateway's KV-swap penalty) must set this, restricting the
    # analytic fast-forward to lone-task cores where their override is
    # a no-op. Overrides that also act on empty-runqueue expiries must
    # disable the fast-forward entirely (_has_ff = False).
    _ff_solo_only = False

    def __init__(
        self,
        n_fifo: Optional[int] = None,
        time_limit_ms: float = 1633.0,
        adapter: Optional[TimeLimitAdapter] = None,
        rightsizer: Optional[Rightsizer] = None,
        sched_latency_ms: float = 24.0,
        min_granularity_ms: float = 3.0,
        **kw,
    ):
        super().__init__(**kw)
        if n_fifo is None:
            n_fifo = self.n_cores // 2      # paper's best split (Fig. 11)
        assert 1 <= n_fifo < self.n_cores, "need at least one core per group"
        self.static_limit_ms = time_limit_ms
        self.adapter = adapter
        self.rightsizer = rightsizer
        self.sched_latency_ms = sched_latency_ms
        self.min_granularity_ms = min_granularity_ms
        self.fifo_queue: deque[Task] = deque()
        self._fifo_requeued = False  # degenerate requeue seen: see below
        self._groups: dict[int, list[Core]] = {GROUP_FIFO: [], GROUP_CFS: []}
        for i, core in enumerate(self.cores):
            core.group = GROUP_FIFO if i < n_fifo else GROUP_CFS
            self._groups[core.group].append(core)
        self._rr_cfs = 0

    # -- group views -----------------------------------------------------
    #
    # Maintained lists in cid order — the same order the historical
    # [c for c in cores if c.group == g] rescans produced, which the
    # idle-core scan and the round-robin migration target index rely on.
    # Treat as read-only; membership changes go through _set_group.
    @property
    def fifo_cores(self) -> list[Core]:
        return self._groups[GROUP_FIFO]

    @property
    def cfs_cores(self) -> list[Core]:
        return self._groups[GROUP_CFS]

    def _set_group(self, core: Core, group: int) -> None:
        self._groups[core.group].remove(core)
        core.group = group
        lst = self._groups[group]
        for i, c in enumerate(lst):
            if c.cid > core.cid:
                lst.insert(i, core)
                return
        lst.append(core)

    def time_limit(self, t: Optional[float] = None) -> float:
        if self.adapter is not None:
            # Flush buffered completion samples due at t so the limit
            # reflects every completion before this instant, whatever
            # batch produced them (None: flush all — end-of-run reads).
            return self.adapter.limit(t)
        return self.static_limit_ms

    def global_queue_len(self) -> int:
        return len(self.fifo_queue)

    def has_idle_core(self) -> bool:
        # New arrivals enter through the FIFO group (Fig. 7): an idle
        # CFS core cannot start them, so it must not make the node look
        # "idle" to a pull-based cluster dispatcher.
        return self.idle_core(self.fifo_cores) is not None

    # -- event hooks -------------------------------------------------------
    def on_start(self) -> None:
        if self.rightsizer is not None:
            self._push(self.rightsizer.interval_ms, 2, "rightsize")

    def on_arrival(self, task: Task, t: float) -> None:
        # New tasks always enter the FIFO group's global queue (Fig. 7).
        self.fifo_queue.append(task)
        core = self.idle_core(self.fifo_cores)
        if core is not None:
            self.dispatch(core, t)

    def pick_next(self, core: Core, t: float):
        if core.group == GROUP_FIFO:
            if self.fifo_queue:
                task = self.fifo_queue.popleft()
                # Remaining budget before this task must migrate to CFS.
                budget = fifo_budget_ms(self.time_limit(t), task.cpu_time)
                return task, budget
            return None
        if core.rq:
            task = core.rq_pop()
            return task, self._cfs_slice(core)
        return None

    def _cfs_slice(self, core: Core) -> float:
        return cfs_slice_ms(core.nr_running, self.sched_latency_ms,
                            self.min_granularity_ms)

    # -- fast-forward (DESIGN.md Sec. 13) ---------------------------------
    #
    # The only way the FIFO group reaches a CFS core is a budget-expiry
    # migration, and the global queue holds only FRESH tasks (cpu_time
    # 0: over-limit tasks migrate to CFS, never back — _migrate_to_cfs's
    # degenerate no-CFS-cores fallback would break that and trips
    # _fifo_requeued, conservatively disabling the relaxations). So
    # with a STATIC limit, nothing a completing FIFO chunk (or a
    # pending arrival) leads to can touch a CFS core earlier than its
    # own instant plus the full static budget every fresh pick gets —
    # CFS batches may run deep into the FIFO group's completion churn
    # and the arrival stream. With the adapter the budget at a future
    # pick is unknowable at push time: fall back to the chunk's own
    # expiry (the pre-batching conservative barrier).
    def _chunk_barrier(self, core: Core, end: float):
        if core.group != GROUP_FIFO:
            return None
        if core.task.remaining - core.chunk_len > _EPS:
            return end               # budget expiry: migrates AT end
        if self.adapter is not None or self._fifo_requeued:
            return end
        return end + self.static_limit_ms

    def _arrival_barrier_offset(self, core: Core) -> float:
        if core.group == GROUP_FIFO:
            return 0.0               # arrival may dispatch this core now
        if self.adapter is not None or self._fifo_requeued:
            return 0.0
        return self.static_limit_ms

    def fast_forward(self, core: Core, end: float, hz: float):
        if core.group != GROUP_CFS:
            return self._fifo_chain_ff(core, end, hz)
        return cfs_fast_forward(self, core, end, hz)

    def _fifo_chain_ff(self, core: Core, end: float, hz: float):
        """Budget-chunk chain on a FIFO-group core: retire a run of
        run-to-completion chunks (queued tasks whose remaining service
        fits their budget) without heap traffic.

        Sound only when a chunk's bookkeeping cannot read state that
        another core's pending event might change first: a STATIC time
        limit (with the adapter, budgets read the completion-ordered
        percentile window at pick time — and other cores' not-yet-run
        batches may still owe samples from earlier instants) and no
        container pool (every FIFO pick is a first dispatch, whose
        acquire must serialize). Bounded by the HEAP TOP, not the
        barrier heap: any other core's chunk end may pop the shared
        global queue, so the chain stops strictly before every pending
        event."""
        if (self.adapter is not None or self.containers is not None
                or not self._batch_complete):
            return end
        task = core.task
        if task.remaining - core.chunk_len > _EPS:
            return end               # budget-limited: expiry migrates
        nxt = self.heap[0][0] if self.heap else _INF
        eps = _EPS
        ctx_ms = self.ctx_switch_ms
        queue = self.fifo_queue
        limit = self.static_limit_ms
        while True:
            if not (end < nxt and end <= hz):
                return end           # engine path processes the expiry
            self._retire_completion(core, end)
            if end < core.locked_until:
                return None          # unlock timer will dispatch
            if not queue:
                return None          # core idles at `end`
            # -- pick_next (FIFO branch), replicated ------------------
            ntask = queue.popleft()
            budget = fifo_budget_ms(limit, ntask.cpu_time)
            ctx = ctx_ms if core.last_task is not ntask else 0.0
            if ntask.first_run is None:
                ntask.first_run = end    # no pool: core-local stamp
            rem = ntask.remaining
            run = rem if rem < budget else budget
            if run < eps:
                run = eps
            core.task = ntask
            core.chunk_start = end
            core.chunk_work_start = end + ctx
            core.chunk_len = run
            core.chunk_rate = 1.0
            if ctx > 0.0:
                ntask.ctx_switches += 1
                self.total_ctx += 1
            end = (end + ctx) + run  # same ops as _start_chunk, rate 1
            if rem - run > eps:
                # Budget-limited chunk: its expiry migrates the task
                # into a CFS runqueue — through the heap, with a
                # barrier (_chunk_interacts), in exact time order.
                return end

    def on_chunk_limit(self, core: Core, task: Task, t: float) -> None:
        if core.group == GROUP_FIFO:
            # Time limit hit: preempt and migrate to a CFS core (round
            # robin distribution over per-core queues, Sec. IV-A).
            task.preemptions += 1
            task.migrations += 1
            core.preempt_count += 1
            self._migrate_to_cfs(task, t)
        else:
            task.vruntime += core.chunk_len
            task.preemptions += 1
            core.preempt_count += 1
            core.rq_push(task)

    def _migrate_to_cfs(self, task: Task, t: float) -> None:
        cfs = self.cfs_cores
        if not cfs:  # degenerate (rightsizer keeps >=1, but be safe)
            # A partially-run task in the global queue voids the
            # fresh-tasks-only premise behind the relaxed barriers.
            self._fifo_requeued = True
            self.fifo_queue.append(task)
            return
        target = cfs[self._rr_cfs % len(cfs)]
        self._rr_cfs += 1
        task.vruntime = max(task.vruntime, target.min_vruntime)
        target.rq_push(task)
        self.kick(target, t)

    def on_complete(self, task: Task, t: float) -> None:
        if self.adapter is not None:
            # Buffered: completion batches may deliver these out of
            # global time order; the adapter re-serializes at the next
            # limit() read (canonical (t, tid) order).
            self.adapter.observe(task.execution, t, task.tid)

    # -- rightsizing ---------------------------------------------------------
    def on_timer(self, payload, t: float) -> None:
        if payload == "rightsize":
            self._rightsize(t)
            self._reschedule_timer("rightsize", self.rightsizer.interval_ms)
            return
        if isinstance(payload, tuple) and payload[0] == "unlock":
            self.dispatch(payload[1], t)
            return
        super().on_timer(payload, t)

    def _group_util(self, cores: list[Core], t: float, window: float) -> float:
        if not cores:
            return 0.0
        acc = 0.0
        for core in cores:
            acc += core.busy_total(t) - getattr(core, "_rs_snap", 0.0)
        return acc / (len(cores) * window)

    def _rightsize(self, t: float) -> None:
        rs = self.rightsizer
        window = rs.interval_ms
        fifo, cfs = self.fifo_cores, self.cfs_cores
        u_fifo = self._group_util(fifo, t, window)
        u_cfs = self._group_util(cfs, t, window)
        n_fifo, n_cfs = len(fifo), len(cfs)
        for core in self.cores:
            core._rs_snap = core.busy_total(t)  # type: ignore[attr-defined]
        if abs(u_fifo - u_cfs) <= rs.threshold:
            return
        if u_fifo > u_cfs and n_cfs > rs.min_group:
            self._migrate_core_cfs_to_fifo(t)
            rs.migrations.append((t, GROUP_CFS, GROUP_FIFO))
        elif u_cfs > u_fifo and n_fifo > rs.min_group:
            self._migrate_core_fifo_to_cfs(t)
            rs.migrations.append((t, GROUP_FIFO, GROUP_CFS))

    def _migrate_core_cfs_to_fifo(self, t: float) -> None:
        """Fig. 8 protocol: lock, preempt, migrate queue, transition, unlock."""
        cfs = self.cfs_cores
        # Pick the CFS core with the shortest queue to disturb least.
        core = min(cfs, key=lambda c: c.nr_running)
        rest = [c for c in cfs if c is not core]
        if not rest:
            return
        # Lock: no new tasks during the transition.
        core.locked_until = t + self.rightsizer.lock_ms
        # Preempt the running task into another CFS core's queue.
        if core.task is not None:
            task = self._interrupt(core, t)
            if task.completion is None:
                task.preemptions += 1
                core.preempt_count += 1
                tgt = min(rest, key=lambda c: c.nr_running)
                task.vruntime = max(task.vruntime, tgt.min_vruntime)
                tgt.rq_push(task)
                self.kick(tgt, t)
        # Migrate queued tasks to the remaining CFS cores (balance sizes).
        while core.rq:
            task = core.rq_pop()
            tgt = min(rest, key=lambda c: c.nr_running)
            tgt.rq_push(task)
            self.kick(tgt, t)
        # Transition + unlock (dispatch after the lock expires).
        self._set_group(core, GROUP_FIFO)
        self._push(core.locked_until, 2, ("unlock", core))

    def _migrate_core_fifo_to_cfs(self, t: float) -> None:
        fifo = self.fifo_cores
        core = min(fifo, key=lambda c: 0 if c.task is None else 1)
        self._set_group(core, GROUP_CFS)
        # A running FIFO task keeps its CPU but is re-chunked under CFS
        # rules (it will be preempted "when we schedule a new task", which
        # under CFS means at its next slice boundary).
        if core.task is not None:
            task = self._interrupt(core, t)
            if task.completion is None:
                task.vruntime = max(task.vruntime, core.min_vruntime)
                core.rq_push(task)
        # Steal tasks from the most loaded CFS cores to balance queues.
        others = [c for c in self.cfs_cores if c is not core]
        if others:
            total = sum(c.nr_running for c in others)
            target_len = total // (len(others) + 1)
            donor = max(others, key=lambda c: c.nr_running)
            while donor.rq and len(core.rq) < target_len:
                task = donor.rq_pop()
                core.rq_push(task)
                donor = max(others, key=lambda c: c.nr_running)
        self.dispatch(core, t)
