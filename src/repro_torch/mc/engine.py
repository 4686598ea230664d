"""The task-level batching layer: cells -> padded arrays -> one launch a
shape bucket -> ``Task`` and ``SimResult`` objects (the task-level body
of ``repro.mc.engine.run_scenarios``, ``src/repro/mc/engine.py:105-215``).

A :class:`Cell` names a policy, its core count, its hybrid knobs and a
built task list. :func:`run_cells` groups the cells by (cores, padded
task count), advances each group in one :func:`~.kernels.run_grid` call,
and writes the outputs into copies of the cells' tasks, so every roll-up
(``SimResult.summary``, the bill) reads exactly what the scalar engine
would have produced. The scenario layer (``supported``, ``run_scenarios``,
``MonteCarlo``, the fleet replay) waits for the port's copy of
``scenario.py``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.events import Task
from ..core.metrics import SimResult
from .dispatch import tasks_supported
from .kernels import run_grid

_INF = float("inf")

# Hybrid defaults mirrored from core.hybrid.HybridScheduler.
_HYBRID_TIME_LIMIT_MS = 1633.0
POLICIES = ("fifo", "cfs", "hybrid")
_HYBRID_KW = {"n_fifo", "time_limit_ms"}


@dataclass
class Cell:
    """One trajectory: ``policy`` on ``n_cores`` cores over ``tasks`` (a
    canonical stream: tids equal list indices, arrivals non-decreasing,
    nothing run yet). ``kw`` holds a hybrid's ``n_fifo`` / ``time_limit_ms``.
    The tasks are copied, so cells may share a list."""

    policy: str
    n_cores: int
    tasks: Sequence[Task]
    kw: dict = field(default_factory=dict)


def _bucket(n: int) -> int:
    """Padded task-slot count: next power of two, floor 64."""
    return max(64, 1 << max(0, (n - 1)).bit_length())


def cell_params(policy: str, n_cores: int, kw: dict) -> tuple[int, float]:
    """(n_fifo, fifo budget limit) of a cell: the two per-cell scalars
    that select the policy inside the kernel. Raises on a cell outside
    the regime."""
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r} not batched; have {POLICIES}")
    if kw and (policy != "hybrid" or not set(kw) <= _HYBRID_KW):
        raise ValueError(f"scheduler kwargs {sorted(kw)} not batched")
    if policy == "fifo":
        return n_cores, _INF
    if policy == "cfs":
        return 0, _INF
    n_fifo = kw.get("n_fifo", n_cores // 2)
    if not 1 <= n_fifo < n_cores:
        raise ValueError("hybrid needs 1 <= n_fifo < n_cores")
    return n_fifo, float(kw.get("time_limit_ms", _HYBRID_TIME_LIMIT_MS))


def pack(cells: Sequence[Cell], n_slots: int) -> tuple[np.ndarray, ...]:
    """The ``run_grid`` arrays of cells of one core count: ``arrival`` and
    ``service`` (B, n_slots), +inf and 1.0 past each cell's tasks, then
    ``n_tasks``, ``n_fifo`` and ``limit`` (B,)."""
    B = len(cells)
    arrival = np.full((B, n_slots), _INF)
    service = np.full((B, n_slots), 1.0)
    n_tasks = np.zeros(B, np.int32)
    n_fifo = np.zeros(B, np.int32)
    limit = np.zeros(B)
    for b, cell in enumerate(cells):
        n = len(cell.tasks)
        arrival[b, :n] = [t.arrival for t in cell.tasks]
        service[b, :n] = [t.service for t in cell.tasks]
        n_tasks[b] = n
        n_fifo[b], limit[b] = cell_params(cell.policy, cell.n_cores, cell.kw)
    return arrival, service, n_tasks, n_fifo, limit


def run_cells(cells: Sequence[Cell], *,
              device: Optional[Union[str, torch.device]] = None
              ) -> list[SimResult]:
    """Run the cells on the batched engine; one ``SimResult`` a cell, in
    order, each with ``mc_stats`` = ``{"iters", "events"}``. Raises
    ``ValueError`` on a cell outside the regime and ``RuntimeError`` if
    a cell did not drain (event cap hit or a task left unfinished).
    ``device=None`` is the card; ``device="cpu"`` the plain version."""
    for cell in cells:
        why = tasks_supported(cell.tasks)
        if why is not None:
            raise ValueError(f"cell outside the batched regime ({why}); "
                             f"run it on the scalar engine")
        cell_params(cell.policy, cell.n_cores, cell.kw)
    tasks = [[copy.copy(t) for t in cell.tasks] for cell in cells]

    groups: dict[tuple[int, int], list[int]] = {}
    for k, cell in enumerate(cells):
        key = (cell.n_cores, _bucket(len(cell.tasks)))
        groups.setdefault(key, []).append(k)

    stats: list[Optional[dict]] = [None] * len(cells)
    for (C, N), ks in groups.items():
        out = run_grid(*pack([cells[k] for k in ks], N), n_cores=C,
                       device=device)
        if not bool(np.all(out["ok"])):
            bad = sorted(k for b, k in enumerate(ks) if not out["ok"][b])
            raise RuntimeError(
                f"batched MC kernel failed to drain cells {bad} (event cap "
                f"hit or tasks left unfinished)")
        comp, fr, cpu = (out[k].tolist() for k in
                         ("completion", "first_run", "cpu_time"))
        npre, nctx, nmig = (out[k].tolist() for k in
                            ("preemptions", "ctx_switches", "migrations"))
        for b, k in enumerate(ks):
            for i, task in enumerate(tasks[k]):
                task.completion = comp[b][i]
                task.first_run = fr[b][i]
                task.preemptions = npre[b][i]
                task.ctx_switches = nctx[b][i]
                task.migrations = nmig[b][i]
                task.cpu_time = cpu[b][i]
                task.remaining = 0.0
            stats[k] = {"iters": int(out["n_iters"][b]),
                        "events": int(out["n_events"][b])}

    return [SimResult(policy=cell.policy, tasks=ts,
                      total_ctx=sum(t.ctx_switches for t in ts),
                      mc_stats=st)
            for cell, ts, st in zip(cells, tasks, stats)]
