"""The traced segment of a ``--trace 1`` run and its reduction.

``torch.profiler`` (CPU and CUDA activities, no shapes, no stacks) runs
over the last ``TRACE_SPAN`` of the window, at most ``TRACE_SPAN_MAX_S``
seconds, started between two engine ticks, when the card has finished
all the work launched before, and stopped once the window has closed
(reading the profiler's events takes seconds, which would otherwise
stall the window). The profiler's own cost on each graph replay shows as
idle time in the traced segment, so a segment as long just before it is
timed untraced: a CUDA event before and after each layer call
(``harness.Marks``), and the device's busy time there is the union of
those calls' intervals (``untraced``: ``busy_s``, ``window_s``, ``calls``;
None off the card). The benchmark's marks (``harness.Marks``) put a
``record_function`` span around each engine tick and each call into a
layer: ``engine.step``, ``prefill``, ``decode``, ``swap_out``,
``swap_in``. Nothing is written to disk: :meth:`Tracer.reduce` reads the
profiler's raw events once and keeps

* ``kernels``: (name, start, end) of each device operation, seconds on
  the trace's clock;
* ``spans``: name -> [(start, end)] of the marks;
* ``busy_s``: the union of the device operations over the segment,
  ``window_s``: the segment, from the first tick's start to the last
  tick's end;
* ``breakdown``: the ten device operations that took most time, and the
  idle time between device operations by what the host was doing then
  (the innermost mark over the gap's middle; ``harness`` outside them).
"""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from .harness import TRACE_SPAN, TRACE_SPAN_MAX_S

MARKS = ("engine.step", "prefill", "decode", "swap_out", "swap_in")


class Tracer:
    def __init__(self, seconds: float, on_card: bool):
        span = min(TRACE_SPAN * seconds, TRACE_SPAN_MAX_S)
        self.t0 = seconds - span
        self.t_timed = self.t0 - span       # the untraced segment's start
        self.on_card = on_card
        self.prof = None
        self.marks = None
        self.events = None
        self.seg = []                       # the untraced segment's ends
        self.timed = None
        self.untraced = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Starts and stops the profiler once in set-up, so that its first
        start (CUPTI's) is not paid inside the window."""
        import torch
        with self._profile():
            torch.ones(8, device="cuda" if self.on_card else "cpu").sum()

    def _edge(self) -> None:
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.seg.append(e)

    def tick(self, elapsed: float) -> None:
        if self.on_card and not self.seg and elapsed >= self.t_timed:
            self._edge()
            self.marks.timed = []
        if self.prof is None and self.events is None and elapsed >= self.t0:
            if self.marks.timed is not None:
                self._edge()
                self.timed, self.marks.timed = self.marks.timed, None
            self._sync()
            self.prof = self._profile()
            self.prof.start()
            self.marks.traced = True

    def _sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def close(self) -> None:
        if self.prof is None:
            return
        self._sync()
        if len(self.seg) == 2:
            a, b = self.seg
            self.untraced = dict(untraced(
                [(a.elapsed_time(x) / 1e3, a.elapsed_time(y) / 1e3)
                 for x, y in self.timed], a.elapsed_time(b) / 1e3),
                calls=len(self.timed))
        self.marks.traced = False
        self.prof.stop()
        # the marks' own ranges on the device's timeline (user
        # annotations) are no device operations
        self.events = [
            (e.name(), e.device_type().name, e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in self.prof.profiler.kineto_results.events()
            if not (e.device_type().name == "CUDA"
                    and (e.is_user_annotation() or e.name() in MARKS))]
        self.prof = None

    def reduce(self) -> dict:
        return dict(reduce(self.events or []), untraced=self.untraced)


def untraced(intervals, window_s: float) -> dict:
    """The device's busy time in a segment of ``window_s`` seconds from
    the (start, end) of its layer calls, seconds from the segment's start:
    their union, clipped to the segment."""
    return {"busy_s": covered(union(intervals), 0.0, window_s),
            "window_s": window_s}


def union(intervals) -> list:
    """Sorted, merged (start, end) of ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged: list, lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def reduce(events: list) -> dict:
    """``events``: (name, device type name, start s, end s) of each raw
    profiler event."""
    kernels = [(n, a, b) for n, dev, a, b in events if dev == "CUDA"]
    spans = defaultdict(list)
    for n, dev, a, b in events:
        if dev == "CPU" and n in MARKS:
            spans[n].append((a, b))
    for v in spans.values():
        v.sort()
    ticks = spans.get("engine.step", [])
    if not ticks:
        return {"kernels": kernels, "spans": dict(spans), "busy_s": 0.0,
                "window_s": 0.0, "breakdown": {"device_ops": [],
                                               "idle_gaps": []}}
    lo, hi = ticks[0][0], ticks[-1][1]
    merged = union((a, b) for _, a, b in kernels)
    busy_s = covered(merged, lo, hi)
    by_name = defaultdict(float)
    for n, a, b in kernels:
        by_name[n] += max(0.0, min(b, hi) - max(a, lo))
    gaps = defaultdict(float)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            gaps[host_doing(spans, (a + b) / 2)] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "spans": dict(spans), "busy_s": busy_s,
            "window_s": hi - lo,
            "breakdown": {"device_ops": [[n[:160], s] for n, s in top],
                          "idle_gaps": sorted(([n, s] for n, s in
                                               gaps.items()),
                                              key=lambda kv: -kv[1])[:10]}}


def host_doing(spans: dict, t: float) -> str:
    """The innermost mark open at ``t`` (a layer call before its tick)."""
    for name in ("prefill", "decode", "swap_out", "swap_in", "engine.step"):
        v = spans.get(name, [])
        i = bisect_right(v, (t, float("inf"))) - 1
        if i >= 0 and v[i][0] <= t <= v[i][1]:
            return name
    return "harness"


def within(kernels: list, spans: list) -> list:
    """For each span, the kernels that start inside it: [(span, [(name,
    start, end)])]."""
    ks = sorted(kernels, key=lambda k: k[1])
    starts = [k[1] for k in ks]
    out = []
    for a, b in spans:
        i, j = bisect_right(starts, a - 1e-12), bisect_right(starts, b)
        out.append(((a, b), ks[i:j]))
    return out
