"""The hybrid scheduler's time-limit adapter (own copy of
``repro.core.hybrid.percentile`` and ``TimeLimitAdapter``).

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
