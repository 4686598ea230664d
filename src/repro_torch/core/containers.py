"""Container/sandbox lifecycle layer (DESIGN.md Sec. 9; own copy of
``repro.core.containers``).

The paper bills users for wall-clock execution, so every millisecond a
sandbox spends initializing is money — yet a scheduler-only simulation
materializes invocations out of thin air. This module gives every
invocation a cold/warm path: a per-node :class:`ContainerPool` keyed by
``func_id`` holds warm *idle* sandboxes (memory-bounded), evicts them on
keep-alive expiry, and charges a cold-start delay (sampled per memory
size) to invocations that miss.

Keep-alive policies:

``fixed``      -- constant TTL per container (OpenWhisk-style).
``histogram``  -- Azure-style (Shahrad et al., "Serverless in the Wild"):
                  per-function keep-alive derived from the observed
                  inter-arrival-time distribution, so a function invoked
                  every 2 s is kept warm ~2.5 s while a once-a-minute
                  function does not pin memory for the full minute.
                  ``prewarm`` hints (``traces.workload.keepalive_hints``)
                  seed the per-function estimate before enough arrivals
                  have been observed.

Accounting is exact per container: a sandbox contributes
``mem_mb x idle-duration`` to ``warm_mb_ms`` only while it is actually
held (TTL evictions stop the meter at the expiry instant, even when the
reaper notices later), which is what the provider-side memory-hold cost
in :mod:`repro_torch.core.cost` integrates.

Deferred releases (DESIGN.md Sec. 13): the engine's completion batches
hand sandboxes back via :meth:`release_at`, which BUFFERS the release
keyed by ``(t, func_id, tid)``. Every pool read or mutation first
drains the buffer up to its own instant, so the pool always applies
releases in canonical time order no matter which per-core batch
produced them first — release/acquire effects commute within a
same-instant batch, with ties resolved by (func_id, tid) instead of
call order, and buffered effects at instant ``t`` apply before any
same-instant read.

Running containers are not tracked here: a running invocation's memory
is accounted by the billing model; the pool bounds only the *idle* warm
set a provider keeps speculatively.
"""
from __future__ import annotations

import heapq
import math
import random
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Optional

# Cold-start model defaults: Firecracker-class base boot plus a
# per-GB image/runtime initialization slope (bigger functions ship
# bigger runtimes), with lognormal jitter.
COLD_BASE_MS = 125.0
COLD_PER_GB_MS = 250.0
COLD_JITTER_SIGMA = 0.25


def expected_cold_ms(mem_mb: float,
                     base_ms: float = COLD_BASE_MS,
                     per_gb_ms: float = COLD_PER_GB_MS) -> float:
    """Mean cold-start delay for a memory size (no jitter) — what a
    cost-aware dispatcher uses to price a cold route."""
    return base_ms + per_gb_ms * (mem_mb / 1024.0)


def _pct(sorted_vals: list[float], pct: float) -> float:
    """Linear-interpolated percentile of a pre-sorted list (local copy:
    importing hybrid.percentile here would cycle events->containers)."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    rank = (pct / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


@dataclass(frozen=True)
class ContainerConfig:
    """Per-node sandbox-pool knobs (picklable: sweep cells carry one)."""

    capacity_mb: float = 4096.0       # memory reserved for idle warm set
    policy: str = "fixed"             # "fixed" | "histogram"
    keepalive_ms: float = 30_000.0    # fixed TTL / histogram fallback
    sweep_ms: float = 1_000.0         # reaper timer period (0 = lazy only)
    cold_base_ms: float = COLD_BASE_MS
    cold_per_gb_ms: float = COLD_PER_GB_MS
    cold_jitter: float = COLD_JITTER_SIGMA
    hist_pct: float = 99.0            # keep-alive = pct of observed IATs
    hist_margin: float = 1.25         # x safety margin over that pct
    hist_window: int = 64             # IAT observations kept per function
    hist_min_ms: float = 2_000.0
    hist_max_ms: float = 120_000.0
    prewarm: Optional[dict] = None    # func_id -> keep-alive hint (ms)
    # Per-function sandbox cap for SLOT-TRACKED dispatch (request_slot/
    # release_slot): at most this many invocations of one func_id hold
    # a sandbox at once; excess dispatches queue FIFO. None = no cap —
    # and the legacy acquire/release path never checks it.
    max_concurrency: Optional[int] = None


class _Warm:
    """One idle warm sandbox.

    ``live`` is the lazy-deletion flag for the capacity-eviction heap:
    acquiring or reaping a container just clears it, and the stale heap
    entry is skipped when it surfaces. ``seq`` is the release order,
    the heap's final tie-breaker (matching the historical append-order
    pop within a bucket)."""

    __slots__ = ("func_id", "mem_mb", "idle_since", "expires_at", "live",
                 "seq")

    def __init__(self, func_id: int, mem_mb: float, idle_since: float,
                 expires_at: float, seq: int = 0):
        self.func_id = func_id
        self.mem_mb = mem_mb
        self.idle_since = idle_since
        self.expires_at = expires_at
        self.live = True
        self.seq = seq


class ContainerPool:
    """Per-node warm-sandbox pool keyed by ``func_id``.

    Invariants (property-tested):

    * the idle warm set never exceeds ``capacity_mb``;
    * ``acquire`` never returns a warm hit for a container whose
      keep-alive expired at or before ``now``;
    * given the same seed and operation sequence, hits/misses, evictions
      and sampled cold-start delays are bit-identical.
    """

    def __init__(self, config: Optional[ContainerConfig] = None, *,
                 seed: int = 0, **overrides):
        if config is None:
            config = ContainerConfig(**overrides)
        elif overrides:
            raise TypeError("pass either a config or keyword overrides")
        self.cfg = config
        self.seed = seed
        self._rng = random.Random(seed ^ 0x5EED)
        self._idle: dict[int, list[_Warm]] = {}  # append-ordered by idle_since
        self.idle_mb = 0.0
        # Incremental eviction machinery (DESIGN.md Sec. 13): the
        # capacity victim — min (idle_since, func_id) over every idle
        # container — comes from a lazy-deletion heap instead of a
        # min() scan over all buckets per eviction, and the TTL reaper
        # skips its full walk entirely while nothing can have expired.
        self._cap_heap: list[tuple[float, int, int, _Warm]] = []
        self._cap_seq = 0
        self._n_idle = 0
        self._min_expiry = float("inf")
        # Deferred releases from engine completion batches: a heap of
        # (t, func_id, tid, mem_mb), drained in canonical time order
        # before any read/mutation at or after t.
        self._pending: list[tuple[float, int, int, float]] = []
        # Per-function concurrency limiting (request_slot/release_slot):
        # slots currently held per func_id, and FIFO queues of
        # (tid, mem_mb) dispatches waiting for one.
        self._running: dict[int, int] = {}
        self._waiters: dict[int, deque] = {}
        # histogram policy state
        self._last_seen: dict[int, float] = {}
        self._iat: dict[int, deque] = {}
        # counters
        self.warm_hits = 0
        self.cold_starts = 0
        self.evictions_ttl = 0
        self.evictions_capacity = 0
        self.evictions_flush = 0  # live sandboxes destroyed by flush()
        self.dropped = 0          # releases larger than the whole pool
        self.prewarmed = 0        # sandboxes provisioned speculatively
        self.warm_mb_ms = 0.0     # integral of idle warm memory over time
        self.n_draws = 0          # cold-start RNG draw counter (stream index)
        self.queued_concurrency = 0   # dispatches deferred by the cap
        self.granted_from_queue = 0   # queued dispatches later admitted

    # -- internal -----------------------------------------------------------
    def _flush(self, upto: float = float("inf")) -> None:
        """Apply buffered releases with timestamp <= ``upto`` in
        canonical (t, func_id, tid) order. Entries AT ``upto`` apply
        before the caller's own operation (same-instant releases are
        visible to a same-instant acquire — the canonical tie rule)."""
        pending = self._pending
        while pending and pending[0][0] <= upto:
            t, fid, _tid, mem = heapq.heappop(pending)
            self.release(fid, mem, t)

    def _maybe_compact(self) -> None:
        # Compact the lazy capacity heap when tombstones exceed half of
        # it, so a long heavy-traffic run cannot accumulate one stale
        # entry per completed invocation (acquires and reaps only
        # tombstone; they never shrink the heap).
        if len(self._cap_heap) > 64 and \
                len(self._cap_heap) > 2 * self._n_idle:
            self._rebuild_cap_heap()

    def _retire(self, c: _Warm, end: float) -> None:
        """Stop the memory meter for one container and drop it. The
        capacity-heap entry is tombstoned (live=False), not searched."""
        self.idle_mb -= c.mem_mb
        self.warm_mb_ms += max(0.0, end - c.idle_since) * c.mem_mb
        c.live = False
        self._n_idle -= 1

    def _keepalive_for(self, func_id: int, now: float) -> float:
        cfg = self.cfg
        if cfg.policy != "histogram":
            return cfg.keepalive_ms
        hint = (cfg.prewarm or {}).get(func_id)
        iats = self._iat.get(func_id)
        if iats is not None and len(iats) >= 3:
            ka = _pct(sorted(iats), cfg.hist_pct) * cfg.hist_margin
        elif hint is not None:
            ka = hint
        else:
            ka = cfg.keepalive_ms
        return min(max(ka, cfg.hist_min_ms), cfg.hist_max_ms)

    def _observe(self, func_id: int, now: float) -> None:
        last = self._last_seen.get(func_id)
        if last is not None and now > last:
            self._iat.setdefault(
                func_id, deque(maxlen=self.cfg.hist_window)).append(now - last)
        self._last_seen[func_id] = now

    def _evict_oldest(self, now: float) -> None:
        # Lazy-deletion pop: the heap orders by (idle_since, func_id,
        # release seq), which selects exactly the container the
        # historical min-over-buckets scan (then bucket-head pop) chose.
        heap = self._cap_heap
        while True:
            _, fid, _, c = heapq.heappop(heap)
            if c.live:
                break
        q = self._idle[fid]
        if q[0] is c:
            q.pop(0)
        else:  # unreachable while release times are monotone; stay safe
            q.remove(c)
        if not q:
            del self._idle[fid]
        self._retire(c, now)
        self.evictions_capacity += 1

    def _rebuild_cap_heap(self) -> None:
        self._cap_heap = [(c.idle_since, fid, c.seq, c)
                          for fid, q in self._idle.items() for c in q]
        heapq.heapify(self._cap_heap)

    # -- lifecycle ----------------------------------------------------------
    def acquire(self, func_id: int, mem_mb: float, now: float) -> bool:
        """Claim a warm sandbox sized ``mem_mb`` for an invocation
        starting at ``now``. Returns True on a warm hit (the container
        leaves the idle set); False means the caller pays a cold start.
        A sandbox only satisfies a same-size request — FaaS functions
        have a fixed memory config, but nothing here assumes it, and a
        1 GB invocation must not "reuse" a 128 MB sandbox for free."""
        self._flush(now)
        self._observe(func_id, now)
        q = self._idle.get(func_id)
        if q:
            # Lazily reap the bucket first (the meter stops at expiry
            # even when the periodic reaper hasn't swept yet).
            live = []
            for c in q:
                if c.expires_at <= now:
                    self._retire(c, c.expires_at)
                    self.evictions_ttl += 1
                else:
                    live.append(c)
            hit = None
            for idx in range(len(live) - 1, -1, -1):
                # most-recently-idled matching size: warmest caches
                if live[idx].mem_mb == mem_mb:
                    hit = live.pop(idx)
                    break
            if live:
                self._idle[func_id] = live
            else:
                del self._idle[func_id]
            if hit is not None:
                self._retire(hit, now)
                self.warm_hits += 1
                self._maybe_compact()
                return True
            self._maybe_compact()  # lazy reaps above tombstoned entries
        self.cold_starts += 1
        return False

    def release(self, func_id: int, mem_mb: float, now: float) -> None:
        """Return a finished invocation's sandbox to the warm set,
        evicting to stay within capacity. Reaping is lazy: only under
        capacity pressure (the meter stops at expiry regardless of when
        a sweep happens, so eager reaping buys no accounting accuracy
        on this per-completion hot path). Expired containers reap first
        — classified as TTL evictions — before any live one is
        sacrificed for capacity."""
        if mem_mb > self.cfg.capacity_mb:
            self.dropped += 1
            return
        if self.idle_mb + mem_mb > self.cfg.capacity_mb:
            self._evict_expired(now)
            while self.idle_mb + mem_mb > self.cfg.capacity_mb:
                self._evict_oldest(now)
        self._admit(func_id, mem_mb, now, self._keepalive_for(func_id, now))

    def _admit(self, func_id: int, mem_mb: float, now: float,
               keepalive_ms: float) -> None:
        """Insert one idle warm sandbox (shared by release and prewarm;
        the caller has already made room)."""
        expires = now + keepalive_ms
        c = _Warm(func_id, mem_mb, now, expires, seq=self._cap_seq)
        self._cap_seq += 1
        self._idle.setdefault(func_id, []).append(c)
        self.idle_mb += mem_mb
        self._n_idle += 1
        heapq.heappush(self._cap_heap, (now, func_id, c.seq, c))
        if expires < self._min_expiry:
            self._min_expiry = expires
        self._maybe_compact()

    def prewarm(self, func_id: int, mem_mb: float, now: float, n: int = 1,
                keepalive_ms: Optional[float] = None) -> int:
        """Provider-initiated speculative provisioning: place up to ``n``
        warm sandboxes for ``func_id`` in the idle set ahead of a
        predicted burst. Unlike ``release``, pre-warming never sacrifices
        an existing LIVE sandbox for room — an observed-warm container is
        evidence, a prediction is a bet — so provisioning stops once only
        live containers stand in the way (expired ones are reaped).
        Returns how many were actually placed. Pre-warmed sandboxes meter
        ``warm_mb_ms`` like any other idle container: prediction is not
        free, it is paid for in provider-side memory-hold dollars."""
        self._flush(now)
        placed = 0
        ka = keepalive_ms if keepalive_ms is not None \
            else self._keepalive_for(func_id, now)
        for _ in range(n):
            if self.idle_mb + mem_mb > self.cfg.capacity_mb:
                self._evict_expired(now)
                if self.idle_mb + mem_mb > self.cfg.capacity_mb:
                    break
            self._admit(func_id, mem_mb, now, ka)
            self.prewarmed += 1
            placed += 1
        return placed

    def flush(self, now: float) -> int:
        """Decommission the warm set (node removal / chaos kill / warm
        pool loss): every idle sandbox is destroyed at ``now``, with its
        memory meter stopped at ``min(expiry, now)`` — an already-expired
        container still counts as a TTL eviction, a live one as a flush
        eviction. Returns the number of LIVE sandboxes destroyed."""
        self._flush(now)
        n_live = 0
        for fid in list(self._idle):
            for c in self._idle.pop(fid):
                if c.expires_at <= now:
                    self._retire(c, c.expires_at)
                    self.evictions_ttl += 1
                else:
                    self._retire(c, now)
                    self.evictions_flush += 1
                    n_live += 1
        self._min_expiry = float("inf")
        self._maybe_compact()
        return n_live

    def release_at(self, func_id: int, mem_mb: float, now: float,
                   tid: int) -> None:
        """Buffered release, keyed (now, func_id, tid): the engine's
        completion batches retire tasks per core, possibly out of
        global time order; the buffer re-serializes their pool effects
        canonically at the next flush (any read or mutation at or
        after ``now``)."""
        heapq.heappush(self._pending, (now, func_id, tid, mem_mb))

    # -- per-function concurrency limits ------------------------------------
    def request_slot(self, func_id: int, mem_mb: float, now: float,
                     tid: int = -1, *, claim: bool = True) -> str:
        """Slot-tracked dispatch under ``cfg.max_concurrency``: claim a
        per-function sandbox slot and (on admission) a warm container.

        Returns ``"warm"`` (admitted, warm hit), ``"cold"`` (admitted,
        pays a cold start) or ``"queued"`` (the function already holds
        ``max_concurrency`` slots; the dispatch joins a FIFO queue and
        is granted by a later :meth:`release_slot` — the caller learns
        which via that call's return value, keyed by ``tid``).

        ``claim=False`` does SLOT ACCOUNTING ONLY — no warm container
        is acquired and ``"admitted"`` replaces the warm/cold verdict.
        This is the cluster-dispatch mode: the node's scheduler decides
        cold vs warm itself on the engine's first-dispatch path, and
        the slot layer must not consume the sandbox it will look for.

        With a fixed per-function memory size (the FaaS config model —
        see :meth:`acquire`), the cap bounds warm+running sandboxes of
        a slot-tracked function: at most ``max_concurrency`` slots run
        at once, every release returns at most one sandbox to the warm
        set, and a warm sandbox re-enters service only by converting
        back into a running slot. The legacy acquire/release path is
        untouched — callers opt into limiting by using the slot API.
        """
        cap = self.cfg.max_concurrency
        self._flush(now)
        if cap is not None and self._running.get(func_id, 0) >= cap:
            self._waiters.setdefault(func_id, deque()).append((tid, mem_mb))
            self.queued_concurrency += 1
            return "queued"
        self._running[func_id] = self._running.get(func_id, 0) + 1
        if not claim:
            return "admitted"
        return "warm" if self.acquire(func_id, mem_mb, now) else "cold"

    def release_slot(self, func_id: int, mem_mb: float, now: float, *,
                     keep_warm: bool = True,
                     claim: bool = True) -> list[tuple[int, str]]:
        """Finish a slot-tracked invocation: free its concurrency slot,
        return the sandbox to the warm set (unless ``keep_warm`` is
        False — crashed/decommissioned sandboxes free the slot only),
        then admit queued dispatches FIFO while slots remain. Returns
        the granted waiters as ``[(tid, "warm" | "cold"), ...]`` (at
        most one per release when a cap is set) so the caller can start
        them. With ``claim=False`` (cluster-dispatch mode, see
        :meth:`request_slot`) grants do not touch the warm set and
        report as ``"granted"``. Raises on a release without a
        matching request."""
        self._flush(now)
        n = self._running.get(func_id, 0)
        if n <= 0:
            raise ValueError(f"release_slot({func_id}) without a "
                             f"matching request_slot")
        if n == 1:
            del self._running[func_id]
        else:
            self._running[func_id] = n - 1
        if keep_warm:
            self.release(func_id, mem_mb, now)
        granted: list[tuple[int, str]] = []
        cap = self.cfg.max_concurrency
        w = self._waiters.get(func_id)
        while w and (cap is None or self._running.get(func_id, 0) < cap):
            tid, wmem = w.popleft()
            self._running[func_id] = self._running.get(func_id, 0) + 1
            self.granted_from_queue += 1
            if not claim:
                granted.append((tid, "granted"))
            else:
                granted.append(
                    (tid, "warm" if self.acquire(func_id, wmem, now)
                     else "cold"))
        if w is not None and not w:
            del self._waiters[func_id]
        return granted

    def drain_slots(self) -> list[int]:
        """Node decommission: forget all slot accounting. Running slots
        die with the machine (their invocations are requeued by the
        cluster layer) and queued waiters are STRANDED — their tids are
        returned so the caller can requeue the waiting dispatches
        through the front-end dispatcher instead of leaking them (a
        plain :meth:`flush` wipes the warm set but must NOT touch slot
        state: a warm-pool loss does not abort running invocations)."""
        stranded = [tid for q in self._waiters.values() for tid, _ in q]
        self._running.clear()
        self._waiters.clear()
        return stranded

    def running_counts(self) -> dict[int, int]:
        """func_id -> slot-tracked running invocations (nonzero only)."""
        return dict(self._running)

    def queue_depths(self) -> dict[int, int]:
        """func_id -> dispatches waiting on a concurrency slot."""
        return {fid: len(q) for fid, q in self._waiters.items()}

    def evict_expired(self, now: float) -> int:
        """Reap every container whose keep-alive lapsed; the memory
        meter stops at the expiry instant, not at ``now``."""
        self._flush(now)
        return self._evict_expired(now)

    def _evict_expired(self, now: float) -> int:
        """Reaper body (no flush: also runs from release under
        capacity pressure, including while the buffer itself is being
        flushed). O(1) while nothing can have expired: ``_min_expiry``
        lower-bounds every live keep-alive (conservatively — acquire
        may remove the minimum without raising it), so the common
        per-second sweep over a quiet pool skips the walk entirely."""
        if now < self._min_expiry:
            return 0
        n = 0
        nxt = float("inf")
        for fid in list(self._idle):
            q = self._idle[fid]
            keep = []
            for c in q:
                if c.expires_at <= now:
                    self._retire(c, c.expires_at)
                    self.evictions_ttl += 1
                    n += 1
                else:
                    keep.append(c)
                    if c.expires_at < nxt:
                        nxt = c.expires_at
            if keep:
                self._idle[fid] = keep
            else:
                del self._idle[fid]
        self._min_expiry = nxt
        self._maybe_compact()
        return n

    def settle(self, now: float) -> None:
        """Bring the memory-hold integral current (end-of-run, or before
        reading stats). Idempotent: still-idle containers re-anchor."""
        self.evict_expired(now)  # flushes deferred releases <= now first
        for q in self._idle.values():
            for c in q:
                self.warm_mb_ms += max(0.0, now - c.idle_since) * c.mem_mb
                c.idle_since = max(c.idle_since, now)
        # Re-anchoring changed the capacity-eviction keys; rebuild the
        # heap so later evictions keep selecting the same victim the
        # rescan implementation would.
        self._rebuild_cap_heap()

    # -- cold-start model ---------------------------------------------------
    def cold_start_ms(self, mem_mb: float) -> float:
        """Sample the init delay a cold invocation pays. Draw number
        ``n_draws`` of the pool's stream: cold starts happen on the
        engine's serialized first-dispatch path in canonical event
        order, so the counter indexes the stream reproducibly — a
        completion batch never draws (releases are draw-free), which is
        what keeps the stream identical however completions are
        batched (DESIGN.md Sec. 13)."""
        self.n_draws += 1
        m = expected_cold_ms(mem_mb, self.cfg.cold_base_ms,
                             self.cfg.cold_per_gb_ms)
        sigma = self.cfg.cold_jitter
        if sigma <= 0.0:
            return m
        return self._rng.lognormvariate(math.log(m) - 0.5 * sigma * sigma,
                                        sigma)

    # -- introspection ------------------------------------------------------
    def warm_counts(self, now: Optional[float] = None) -> dict[int, int]:
        """func_id -> number of idle warm sandboxes (heartbeat payload).
        Pass ``now`` to apply only deferred releases due by then;
        without it ALL are applied — only safe when the pool is
        quiescent or at a time past every buffered completion."""
        self._flush(float("inf") if now is None else now)
        return {fid: len(q) for fid, q in self._idle.items()}

    def live_view(self, now: float) -> tuple[dict[int, int], float]:
        """(warm counts, warm MB) counting only unexpired sandboxes —
        the heartbeat payload. Applies deferred releases due at
        ``now`` but never expires/evicts anything itself (this runs per
        node per routing decision)."""
        self._flush(now)
        counts: dict[int, int] = {}
        mb = 0.0
        for fid, q in self._idle.items():
            k = 0
            for c in q:
                if c.expires_at > now:
                    k += 1
                    mb += c.mem_mb
            if k:
                counts[fid] = k
        return counts, mb

    def has_warm(self, func_id: int, now: Optional[float] = None) -> bool:
        """See warm_counts: pass ``now`` unless the pool is quiescent."""
        self._flush(float("inf") if now is None else now)
        return bool(self._idle.get(func_id))

    def stats(self) -> dict:
        self._flush()
        total = self.warm_hits + self.cold_starts
        return {
            "warm_hits": self.warm_hits,
            "cold_starts": self.cold_starts,
            "cold_start_rate": (self.cold_starts / total) if total else 0.0,
            "evictions_ttl": self.evictions_ttl,
            "evictions_capacity": self.evictions_capacity,
            "evictions_flush": self.evictions_flush,
            "dropped": self.dropped,
            "prewarmed": self.prewarmed,
            "idle_mb": self.idle_mb,
            "warm_mb_ms": self.warm_mb_ms,
            "queued_concurrency": self.queued_concurrency,
            "granted_from_queue": self.granted_from_queue,
            "queue_depth": sum(len(q) for q in self._waiters.values()),
        }

    def check_invariants(self) -> None:
        """Raise if internal accounting drifted (test hook)."""
        self._flush()
        total = sum(c.mem_mb for q in self._idle.values() for c in q)
        assert abs(total - self.idle_mb) < 1e-6, \
            f"idle_mb gauge {self.idle_mb} != actual {total}"
        assert self.idle_mb <= self.cfg.capacity_mb + 1e-6, \
            f"warm set {self.idle_mb} MB over capacity {self.cfg.capacity_mb}"
        for q in self._idle.values():
            assert q, "empty per-function bucket left behind"
        live = {id(c) for q in self._idle.values() for c in q}
        heap_live = {id(e[3]) for e in self._cap_heap if e[3].live}
        assert live == heap_live, \
            "capacity heap out of sync with the idle set"
        assert self._n_idle == len(live), \
            f"_n_idle gauge {self._n_idle} != actual {len(live)}"
        # Tombstone bound: _maybe_compact caps the lazy heap at twice
        # the live count (above the 64-entry floor), so stale entries
        # cannot grow without bound in long heavy-traffic runs.
        assert len(self._cap_heap) <= max(64, 2 * self._n_idle), \
            (f"capacity heap {len(self._cap_heap)} entries for "
             f"{self._n_idle} live containers — compaction not firing")
        cap = self.cfg.max_concurrency
        assert all(n > 0 for n in self._running.values()), \
            "zero/negative slot count left in _running"
        if cap is None:
            assert not self._waiters, \
                "waiters queued with no concurrency cap configured"
        else:
            for fid, n in self._running.items():
                assert n <= cap, \
                    f"func {fid} holds {n} slots over cap {cap}"
            for fid, q in self._waiters.items():
                assert q, "empty waiter queue left behind"
                assert self._running.get(fid, 0) == cap, \
                    (f"func {fid} queues {len(q)} dispatches while "
                     f"holding only {self._running.get(fid, 0)}/{cap}")


# -- the ONE way to say "containers" ------------------------------------------

@dataclass(frozen=True)
class ContainerSpec:
    """Declarative sandbox-layer spec — the single currency for the
    ``containers=`` argument across every entrypoint (``Scenario``,
    ``Scheduler``, ``ClusterSim``, the serving gateway, sweep cells).

    Where :class:`ContainerConfig` is the pool's full knob set, a spec
    is the *intent*: which keep-alive policy, how much warm capacity,
    and optionally a cold-start cost model override (the LLM scenario
    prices cold = weight-load + compile through these three fields).
    ``None`` overrides inherit the ``ContainerConfig`` defaults.

    ``hints=True`` (histogram policy only) seeds per-function keep-alive
    hints from the workload's own inter-arrival distribution at run
    time — exactly what ``sweep._cell_containers`` historically did —
    which is why the workload-dependent conversion lives in
    :meth:`to_config` rather than in the frozen spec itself.
    """

    policy: str = "fixed"             # "off" | "fixed" | "histogram"
    capacity_mb: float = 4096.0
    keepalive_ms: float = 30_000.0
    hints: bool = True
    cold_base_ms: Optional[float] = None
    cold_per_gb_ms: Optional[float] = None
    cold_jitter: Optional[float] = None
    max_concurrency: Optional[int] = None   # per-function slot cap

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    @classmethod
    def from_legacy(cls, obj) -> "ContainerSpec | None":
        """Coerce every historical ``containers=`` shape to a spec.

        Accepts ``None`` (off), a policy-name string (``"off"`` /
        ``"fixed"`` / ``"histogram"`` — the sweep-cell encoding), a
        kwargs dict, a raw :class:`ContainerConfig`, or a spec.
        """
        if obj is None:
            return None
        if isinstance(obj, ContainerSpec):
            return obj
        if isinstance(obj, str):
            if obj not in ("off", "fixed", "histogram"):
                raise KeyError(f"unknown container policy {obj!r}")
            return None if obj == "off" else cls(policy=obj)
        if isinstance(obj, ContainerConfig):
            return cls(policy=obj.policy, capacity_mb=obj.capacity_mb,
                       keepalive_ms=obj.keepalive_ms,
                       hints=obj.prewarm is not None,
                       cold_base_ms=obj.cold_base_ms,
                       cold_per_gb_ms=obj.cold_per_gb_ms,
                       cold_jitter=obj.cold_jitter,
                       max_concurrency=obj.max_concurrency)
        if isinstance(obj, dict):
            return cls(**obj)
        raise TypeError(f"cannot build ContainerSpec from {type(obj)!r}")

    def to_config(self, tasks=None) -> Optional[ContainerConfig]:
        """Materialize the pool config. ``tasks`` (the workload about to
        run, post load-scaling) feeds histogram keep-alive hints when
        ``hints`` is set; without it the pool estimates online only."""
        if not self.enabled:
            return None
        overrides = {k: v for k, v in (
            ("cold_base_ms", self.cold_base_ms),
            ("cold_per_gb_ms", self.cold_per_gb_ms),
            ("cold_jitter", self.cold_jitter),
            ("max_concurrency", self.max_concurrency)) if v is not None}
        cfg = ContainerConfig(policy=self.policy,
                              capacity_mb=self.capacity_mb,
                              keepalive_ms=self.keepalive_ms, **overrides)
        if self.policy == "histogram" and self.hints and tasks is not None:
            from ..traces.workload import keepalive_hints
            cfg = replace(cfg, prewarm=keepalive_hints(tasks, cfg))
        return cfg


def as_container_config(obj, tasks=None) -> Optional[ContainerConfig]:
    """Normalize any accepted ``containers=`` value to a pool config.

    ``ContainerConfig`` instances pass through UNTOUCHED (legacy callers
    keep bit-identical behaviour); specs / dicts / policy strings are
    materialized via :meth:`ContainerSpec.to_config`.
    """
    if obj is None or isinstance(obj, (ContainerConfig, ContainerPool)):
        return obj
    spec = ContainerSpec.from_legacy(obj)
    return None if spec is None else spec.to_config(tasks)
