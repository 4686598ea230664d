"""The batching layer: cells -> padded arrays -> one launch a shape bucket
-> ``Task``, ``SimResult``, ``ClusterResult`` and ``ScenarioResult``
objects (own copy of ``repro.mc.engine``).

A :class:`Cell` names a policy, its core count, its hybrid knobs and a
built task list. :func:`run_cells` groups the cells by (cores, padded
task count), advances each group in one :func:`~.kernels.run_grid` call,
and writes the outputs into copies of the cells' tasks, so every roll-up
(``SimResult.summary``, the bill) reads exactly what the scalar engine
would have produced.

:func:`run_scenarios` is the Scenario layer over the same launches: it
decomposes each in-regime scenario (``dispatch.supported``) into kernel
cells (a single-node scenario is one cell; an admitted flat fleet one
cell a node, holding the dispatch subsequence its state-oblivious
dispatcher is replayed to in Python), then rebuilds the ``ScenarioResult``
the scalar engine gives, bit for bit.
"""
from __future__ import annotations

import copy
import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Sequence, Union

import numpy as np
import torch

from ..core.events import Task
from ..core.metrics import SimResult
from .dispatch import _HYBRID_KW, SUPPORTED_POLICIES, supported, \
    tasks_supported
from .kernels import run_grid

if TYPE_CHECKING:
    from ..cluster.metrics import ClusterResult
    from ..scenario import Scenario, ScenarioResult

_INF = float("inf")

# Hybrid defaults mirrored from core.hybrid.HybridScheduler.
_HYBRID_TIME_LIMIT_MS = 1633.0
Device = Optional[Union[str, torch.device]]


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
    if policy not in SUPPORTED_POLICIES:
        raise ValueError(f"policy {policy!r} not batched; have "
                         f"{SUPPORTED_POLICIES}")
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


def scenario_cell(sc: "Scenario", tasks: Sequence[Task]) -> Cell:
    """The kernel cell of a supported scenario's node over ``tasks``:
    ``cell_params`` of this cell is JAX's ``cell_params(sc)``."""
    return Cell(sc.policy.name, sc.fleet.cores_per_node, tasks,
                dict(sc.policy.kw))


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


def _launch(cells: Sequence[Cell], device: Device) -> list[dict]:
    """Advance the cells, one ``run_grid`` call a (cores, padded slots)
    bucket, and write each output into the cell's own task objects;
    returns each cell's ``{"iters", "events"}``. Raises ``RuntimeError``
    if a cell did not drain (event cap hit or a task left unfinished)."""
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
            for i, task in enumerate(cells[k].tasks):
                task.completion = comp[b][i]
                task.first_run = fr[b][i]
                task.preemptions = npre[b][i]
                task.ctx_switches = nctx[b][i]
                task.migrations = nmig[b][i]
                task.cpu_time = cpu[b][i]
                task.remaining = 0.0
            stats[k] = {"iters": int(out["n_iters"][b]),
                        "events": int(out["n_events"][b])}
    return stats


def run_cells(cells: Sequence[Cell], *, device: Device = None
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
    cells = [Cell(c.policy, c.n_cores, [copy.copy(t) for t in c.tasks], c.kw)
             for c in cells]
    stats = _launch(cells, device)
    return [SimResult(policy=cell.policy, tasks=cell.tasks,
                      total_ctx=sum(t.ctx_switches for t in cell.tasks),
                      mc_stats=st)
            for cell, st in zip(cells, stats)]


def replay_assignments(sc: "Scenario", n_tasks: int) -> list[int]:
    """Node index a task, in canonical stream order. Exact because the
    admitted dispatchers never observe node state: ``round_robin`` is a
    counter over dispatch order, ``random`` draws once a dispatch from
    ``random.Random(fleet.seed)``, and the canonical-stream check makes
    ``ClusterSim``'s (arrival, tid) dispatch order the list order."""
    name = sc.fleet.dispatcher
    n = sc.fleet.n_nodes
    if name == "round_robin":
        return [k % n for k in range(n_tasks)]
    if name == "random":
        rng = random.Random(sc.fleet.seed)
        return [rng.randrange(n) for _ in range(n_tasks)]
    raise ValueError(f"dispatcher {name!r} is not replayable")


def _fleet_result(sc: "Scenario", tasks, sel: list[int]) -> "ClusterResult":
    """The ``ClusterResult`` that ``ClusterSim.result()`` gives for an
    in-regime fleet: the flat node0..node{n-1} roster, assignments in
    dispatch order, unit price multipliers, no resilience bookkeeping
    (the gate refuses every such layer)."""
    from ..cluster.metrics import ClusterResult

    fl, pol = sc.fleet, sc.policy
    n = fl.n_nodes
    node_ids = [f"node{i}" for i in range(n)]
    per_node: list[list] = [[] for _ in range(n)]
    for j, i in enumerate(sel):
        per_node[i].append(tasks[j])
    node_results = [
        SimResult(policy=pol.name, tasks=ts,
                  total_ctx=sum(t.ctx_switches for t in ts))
        for ts in per_node]
    meta = [{"node_id": nid, "zone": None, "rack": None, "sku": None,
             "spot": False, "price_mult": 1.0, "base_price_mult": 1.0,
             "spot_discount": 0.0} for nid in node_ids]
    return ClusterResult(
        node_results=node_results,
        node_ids=node_ids,
        node_policies=[pol.name] * n,
        dispatcher=fl.dispatcher,
        cores_per_node=fl.cores_per_node,
        assignments=[(tasks[j].tid, node_ids[i])
                     for j, i in enumerate(sel)],
        node_meta=meta,
    )


def run_scenarios(scenarios: Sequence["Scenario"],
                  prebuilt: Optional[Sequence] = None, *,
                  device: Device = None) -> list["ScenarioResult"]:
    """Run in-regime scenarios on the batched engine.

    ``prebuilt`` optionally supplies ``(tasks, meta)`` a scenario (e.g.
    ``MonteCarlo`` builds each trace once); otherwise each
    ``workload.build()`` runs here. Raises ``ValueError`` on an
    out-of-regime scenario: callers partition with
    ``dispatch.supported`` first. Each result carries ``mc_stats`` =
    ``{"iters", "events"}``, summed over a fleet's node cells.
    ``device=None`` is the card; ``device="cpu"`` the plain version.
    """
    from ..scenario import ScenarioResult

    built = []
    for k, sc in enumerate(scenarios):
        why = supported(sc)
        tasks = meta = None
        if why is None:
            tasks, meta = (prebuilt[k] if prebuilt is not None
                           else sc.workload.build())
            why = tasks_supported(tasks)
        if why is not None:
            raise ValueError(f"scenario outside the batched regime "
                             f"({why}); route it to the scalar engine")
        built.append((tasks, meta))

    # Kernel cells: a fleet's nodes never interact once assignments are
    # fixed, so each node's subsequence is an independent cell. Its tids
    # are not its list indices, so the canonical check above ran on the
    # whole stream; the outputs land in the stream's own task objects.
    cells: list[Cell] = []
    owner: list[int] = []
    fleet_sel: dict[int, list[int]] = {}
    for k, sc in enumerate(scenarios):
        tasks = built[k][0]
        if sc.fleet.is_fleet:
            sel = replay_assignments(sc, len(tasks))
            fleet_sel[k] = sel
            for i in range(sc.fleet.n_nodes):
                sub = [t for t, s in zip(tasks, sel) if s == i]
                if sub:           # an empty node needs no kernel cell
                    cells.append(scenario_cell(sc, sub))
                    owner.append(k)
        else:
            cells.append(scenario_cell(sc, tasks))
            owner.append(k)

    iters = [0] * len(scenarios)
    events = [0] * len(scenarios)
    for k, st in zip(owner, _launch(cells, device)):
        iters[k] += st["iters"]
        events[k] += st["events"]

    results: list["ScenarioResult"] = []
    for k, sc in enumerate(scenarios):
        tasks, meta = built[k]
        if sc.fleet.is_fleet:
            raw = _fleet_result(sc, tasks, fleet_sel[k])
        else:
            raw = SimResult(
                policy=sc.policy.name, tasks=tasks,
                total_ctx=sum(t.ctx_switches for t in tasks))
        results.append(ScenarioResult(
            scenario=sc, raw=raw, meta=dict(meta),
            mc_stats={"iters": iters[k], "events": events[k]}))
    return results
