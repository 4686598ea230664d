"""Arithmetic the metric readers share: percentiles, the requests of the
window, and the traced layer calls matched to their device operations."""
from __future__ import annotations

from . import costs
from .trace import union, within


def percentile(values: list, pct: float) -> float:
    """Linear interpolation between the closest ranks of the sorted
    values (numpy's default)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    rank = pct / 100.0 * (len(v) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (rank - lo)


def due_in_window(rec) -> list:
    return [r for r in rec.reqs.values() if rec.start <= r.due < rec.end]


def waited(rec, stamp: str) -> list:
    """Seconds from due to ``stamp`` (``t_prefill``, ``t_first``) of every
    request due in the window; one still waiting at the window's end
    counts with its wait so far."""
    out = []
    for r in due_in_window(rec):
        t = getattr(r, stamp)
        out.append((t if t is not None and t <= rec.end else rec.end) - r.due)
    return out


def traced(rec, kind: str) -> list:
    """[(host call, (span start, end), kernels inside)] of the traced
    ``prefill`` or ``decode`` calls, the host's records and the trace's
    spans matched in order."""
    if rec.trace is None:
        return []
    calls = [c for c in (rec.prefills if kind == "prefill" else rec.decodes)
             if c[4]]
    spans = rec.trace["spans"].get(kind, [])
    if len(calls) != len(spans):
        raise RuntimeError(f"{len(calls)} traced {kind} calls on the host, "
                           f"{len(spans)} {kind} spans in the trace")
    return [(c, span, ks) for c, (span, ks) in
            zip(calls, within(rec.trace["kernels"], spans))]


def device_s(kernels: list) -> float:
    """Seconds in which one of ``kernels`` ran (their union)."""
    return sum(b - a for a, b in union((a, b) for _, a, b in kernels))


def group_s(kernels: list, group: str) -> float:
    return device_s([k for k in kernels if costs.group_of(k[0]) == group])


def share(bound_s: float, time_s: float):
    """A roofline share in %, or None where nothing ran."""
    return 100.0 * bound_s / time_s if time_s > 0 else None


def idle_share(rec):
    """The device's idle share of the untraced segment, in %."""
    u = rec.trace and rec.trace.get("untraced")
    if not u or u["window_s"] <= 0 or u["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - u["busy_s"] / u["window_s"])
