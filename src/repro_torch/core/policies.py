"""Single-level scheduling policies (paper Sec. III-C; own copy of
``repro.core.policies``).

FIFO          -- run to completion, global queue, no preemption.
FIFOPreempt   -- paper's FIFO_100ms: preempt after a fixed per-chunk budget
                 and move to the END of the global queue (Sec. II-D).
RoundRobin    -- global queue, fixed quantum.
CFS           -- per-core runqueues ordered by vruntime with
                 sched_latency / min_granularity slicing (Linux defaults for
                 a ~50 core box), least-loaded core placement on wakeup.
EDF           -- preemptive earliest-deadline-first, centralized.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from .events import (_EPS, Core, Scheduler, Task, cfs_fast_forward,
                     cfs_slice_ms)


class FIFO(Scheduler):
    name = "fifo"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.queue: deque[Task] = deque()

    def on_arrival(self, task: Task, t: float) -> None:
        self.queue.append(task)
        core = self.idle_core()
        if core is not None:
            self.dispatch(core, t)

    def global_queue_len(self) -> int:
        return len(self.queue)

    def pick_next(self, core: Core, t: float):
        if self.queue:
            return self.queue.popleft(), None
        return None

    def on_chunk_limit(self, core: Core, task: Task, t: float) -> None:
        raise AssertionError("FIFO never sets a chunk limit")


class FIFOPreempt(FIFO):
    """FIFO with per-chunk preemption budget (FIFO_100ms in the paper)."""

    name = "fifo_preempt"
    _has_ff = True

    def __init__(self, quantum_ms: float = 100.0, **kw):
        super().__init__(**kw)
        self.quantum_ms = quantum_ms

    def pick_next(self, core: Core, t: float):
        if self.queue:
            return self.queue.popleft(), self.quantum_ms
        return None

    def on_chunk_limit(self, core: Core, task: Task, t: float) -> None:
        task.preemptions += 1
        core.preempt_count += 1
        self.queue.append(task)  # to the END of the global queue

    def fast_forward(self, core: Core, end: float, hz: float):
        # A lone task with an empty global queue cycles append ->
        # popleft with itself: retire whole quantum rounds analytically,
        # then the final completion (the queue is empty, so the core
        # goes idle — no pick can follow). Every core shares the global
        # queue, so ANY other pending event (including other cores'
        # expiries, which may queue their task) bounds the loop — the
        # heap top, not just the barrier heap.
        if self.queue or self.interference_fn is not None:
            return end
        q = self.quantum_ms
        task = core.task
        nxt = self.heap[0][0] if self.heap else float("inf")
        if core.chunk_len == q and task.remaining - q > _EPS:
            t = core.chunk_start
            e = end
            busy = core.busy_ms
            n = 0
            cur_run = q
            while True:
                if not (e < nxt and e <= hz):
                    break
                nrem = task.remaining - q
                if nrem <= _EPS:
                    break            # chunk completes; retired below
                task.remaining = nrem
                task.cpu_time += q
                busy += e - t
                task.preemptions += 1
                n += 1
                run = nrem if nrem < q else q
                if run < _EPS:
                    run = _EPS
                t = e
                e = t + 0.0 + run    # ctx == 0: same task keeps the core
                cur_run = run
                if run != q:
                    break            # final partial chunk is in flight
            if n:
                core.last_task = task
                core.chunk_start = t
                core.chunk_work_start = t + 0.0
                core.chunk_len = cur_run
                core.busy_ms = busy
                core.preempt_count += n
                self.n_events += n
                end = e
        # Retire the chain's completion when it lands before every
        # other pending event: queue empty means the core idles after.
        if (self._batch_complete
                and task.remaining - core.chunk_len <= _EPS
                and end < nxt and end <= hz):
            self._retire_completion(core, end)
            return None
        return end


class RoundRobin(FIFOPreempt):
    name = "rr"

    def __init__(self, quantum_ms: float = 24.0, **kw):
        super().__init__(quantum_ms=quantum_ms, **kw)


class CFS(Scheduler):
    """Completely Fair Scheduler model.

    Each core keeps a vruntime-ordered runqueue. The slice granted to the
    picked task is max(sched_latency / nr_running, min_granularity); on
    expiry the task's vruntime advances by the executed time and it is
    reinserted. New tasks are placed on the least-loaded core and start at
    that core's min_vruntime (so they neither starve nor dominate).
    """

    name = "cfs"
    _has_ff = True
    # See HybridScheduler._ff_solo_only: subclasses whose on_chunk_limit
    # does extra work only when the runqueue is non-empty set this to
    # keep the analytic fast-forward on lone-task cores only.
    _ff_solo_only = False

    def __init__(self, sched_latency_ms: float = 24.0,
                 min_granularity_ms: float = 3.0, **kw):
        super().__init__(**kw)
        self.sched_latency_ms = sched_latency_ms
        self.min_granularity_ms = min_granularity_ms
        self._rr = 0

    # -- placement ------------------------------------------------------
    def _least_loaded(self) -> Core:
        best, best_nr = None, None
        n = self.n_cores
        start = self._rr
        self._rr = (self._rr + 1) % n
        for i in range(n):
            core = self.cores[(start + i) % n]
            nr = core.nr_running
            if nr == 0 and core.task is None:
                return core
            if best_nr is None or nr < best_nr:
                best, best_nr = core, nr
        return best

    def on_arrival(self, task: Task, t: float) -> None:
        core = self._least_loaded()
        task.vruntime = max(task.vruntime, core.min_vruntime)
        core.rq_push(task)
        self.kick(core, t)

    def slice_for(self, core: Core) -> float:
        return cfs_slice_ms(core.nr_running, self.sched_latency_ms,
                            self.min_granularity_ms)

    def pick_next(self, core: Core, t: float):
        if core.rq:
            task = core.rq_pop()
            return task, self.slice_for(core)
        return None

    def on_chunk_limit(self, core: Core, task: Task, t: float) -> None:
        task.vruntime += core.chunk_len
        task.preemptions += 1
        core.preempt_count += 1
        core.rq_push(task)

    def fast_forward(self, core: Core, end: float, hz: float) -> float:
        return cfs_fast_forward(self, core, end, hz)


class EDF(Scheduler):
    """Preemptive earliest-deadline-first with a centralized queue.

    Deadlines are SLO-style: arrival + slack_factor * expected service
    (set by the workload generator). An arrival with an earlier deadline
    preempts the running task with the latest deadline.
    """

    name = "edf"

    def __init__(self, **kw):
        super().__init__(**kw)
        import heapq
        self._heapq = heapq
        self.queue: list = []
        self._qseq = 0

    def _qpush(self, task: Task) -> None:
        self._heapq.heappush(self.queue, (task.deadline, self._qseq, task))
        self._qseq += 1

    def global_queue_len(self) -> int:
        return len(self.queue)

    def on_arrival(self, task: Task, t: float) -> None:
        core = self.idle_core()
        if core is not None:
            self._qpush(task)
            self.dispatch(core, t)
            return
        # No idle core: consider preempting the latest-deadline running task.
        victim_core, victim_dl = None, task.deadline
        for core in self.cores:
            if core.task is not None and core.task.deadline > victim_dl:
                victim_core, victim_dl = core, core.task.deadline
        self._qpush(task)
        if victim_core is not None:
            victim = self._interrupt(victim_core, t)
            if victim.completion is None:
                victim.preemptions += 1
                victim_core.preempt_count += 1
                self._qpush(victim)
            self.dispatch(victim_core, t)

    def pick_next(self, core: Core, t: float):
        if self.queue:
            _, _, task = self._heapq.heappop(self.queue)
            return task, None
        return None

    def on_chunk_limit(self, core: Core, task: Task, t: float) -> None:
        raise AssertionError("EDF chunks run to completion unless preempted")
