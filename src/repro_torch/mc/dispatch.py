"""The task-level half of the batched engine's regime gate (own copy of
``Refusal``, ``reason_key`` and ``tasks_supported`` of
``repro.mc.dispatch``).

A refusal is a plain human-readable string that also carries a stable
``key``. ``tasks_supported`` checks a built task list: the kernel
reproduces the scalar engine only for a canonical stream (tids equal list
indices, arrivals non-decreasing, no auxiliary tasks, nothing run yet).
"""
from __future__ import annotations

from typing import Optional


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


def tasks_supported(tasks) -> Optional[Refusal]:
    """None for a canonical task stream, else why it is not one."""
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
