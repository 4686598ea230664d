"""Times the batched Monte-Carlo kernel ``mc_cell`` on the card.

  PYTHONPATH=src python -m repro_torch.launch.mc_time

Builds the paper grid (``mc/paper_digests.py``: 50 cores, the default
trace at seeds 0-3 under fifo / cfs / hybrid, 12 cells) and times, with
CUDA events around one launch each: the grid's launch; each policy's
seed-0 cell alone and the slowest cell alone, as ns and cycles an event
(cycles at the card's top SM clock, ``nvidia-smi`` ``clocks.max.sm``);
a sweep of the grid repeated ``SWEEP_REPS`` times in one launch, as
cells/s; and the cells of ``long_queue_cells`` alone, whose runqueues
run long, with a digest of each one's outputs. Every cell of the paper
grid and of the sweep must match the scalar engine's digest, and every
cell must drain, else it exits non-zero. It uses only entry points that
every version of the port's MC kernel has, so a copy of it run in
another checkout times that checkout's kernel; the last line is a JSON
object of the numbers.
"""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace
from typing import Callable, Sequence

import torch

from ..core.events import Task
from ..kernels.mc_cell import mc_cell_cuda
from ..mc import paper_digests as pd
from ..mc.engine import Cell, _bucket, pack
from ..traces.workload import scale_load

FIELDS = ("completion", "first_run", "cpu_time", "preemptions",
          "ctx_switches", "migrations")
SWEEP_REPS = 11  # the paper grid 11 times over: 132 cells, one a SM


def sm_clock_mhz() -> float:
    """The card's top SM clock, MHz (first card)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(res.stdout.split()[0])


def timed(fn: Callable[[], dict]) -> tuple[dict, float]:
    """fn() between two CUDA events: (its result, ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def row_digests(out: dict, n_tasks: list[int]) -> list[str]:
    """``paper_digests.cell_digest`` of each row of the kernel's outputs."""
    cols = {k: out[k].cpu().tolist() for k in FIELDS}
    return [pd.cell_digest([SimpleNamespace(
        tid=i, **{k: cols[k][b][i] for k in FIELDS}) for i in range(n)])
        for b, n in enumerate(n_tasks)]


def paper_grid() -> tuple[list[torch.Tensor], int, list[tuple], list[int]]:
    """The paper grid's arrays on the card, its cores, its (policy, seed)
    keys and task counts, in ``paper_cells`` order."""
    cells = pd.paper_cells()
    n_slots = max(_bucket(len(c.tasks)) for c in cells)
    args = [torch.from_numpy(a).cuda() for a in pack(cells, n_slots)]
    keys = [(p, s) for s in pd.SEEDS for p in pd.POLICIES]
    return args, cells[0].n_cores, keys, [len(c.tasks) for c in cells]


def long_queue_cells() -> list[tuple[str, Cell]]:
    """Cells whose CFS runqueues run long, named: 2000 short tasks at once
    on 50 cores (40 a core under cfs; the hybrid, with a 1 ms limit,
    migrates them onto its CFS cores at their min_vruntime), and cfs on
    the paper's seed-0 trace at 1.5 times its load. (Its fifo and hybrid
    cells at 1.5 are the load-1.0 cells over again: their FIFO queue
    never empties at either load, so arrivals do not move them.)"""
    crowd = [Task(tid=i, arrival=0.0, service=(3.0, 6.0, 9.5, 12.0)[i % 4])
             for i in range(2000)]
    heavy = scale_load(pd.paper_cells(seeds=(0,))[0].tasks, 1.5)
    return [("crowd cfs", Cell("cfs", 50, crowd)),
            ("crowd hybrid, 1 ms limit",
             Cell("hybrid", 50, crowd, {"time_limit_ms": 1.0})),
            ("cfs at load 1.5", Cell("cfs", 50, heavy))]


def mismatches(out: dict, keys: list[tuple], n_tasks: list[int]
               ) -> list[int]:
    """The rows whose digest differs from the scalar engine's for their
    cell (row b is cell b mod the grid's size) or that did not drain."""
    B = out["ok"].shape[0]
    cell = [b % len(keys) for b in range(B)]
    got = row_digests(out, [n_tasks[c] for c in cell])
    ok = out["ok"].tolist()
    return [b for b in range(B)
            if got[b] != pd.DIGESTS[keys[cell[b]]] or not ok[b]]


def check(out: dict, keys: list[tuple], n_tasks: list[int],
          label: str) -> int:
    bad = mismatches(out, keys, n_tasks)
    if bad:
        sys.exit(f"mc_time: {label}: rows {bad[:8]} differ from the scalar "
                 "engine")
    return out["ok"].shape[0]


def paper_rows(events: Sequence[int]) -> list[int]:
    """The paper grid's rows to time alone: each policy's seed-0 cell
    and the slowest cell."""
    slow = max(range(len(events)), key=lambda b: events[b])
    return sorted(set(range(len(pd.POLICIES))) | {slow})


def time_row(args: list[torch.Tensor], n_cores: int, b: int, events: int,
             mhz: float) -> dict:
    """Row b of a grid alone, one timed launch: ms, and ns and cycles an
    event of its ``events``."""
    one = [x[b:b + 1] for x in args]
    _, ms = timed(lambda: mc_cell_cuda(*one, n_cores=n_cores))
    ns = ms * 1e6 / events
    return {"ms": ms, "events": events, "ns": ns, "cycles": ns * mhz / 1e3}


def describe(r: dict, mhz: float) -> str:
    return (f"alone {r['ms']:.2f} ms, {r['events']} events, {r['ns']:.1f} "
            f"ns an event, {r['cycles']:.0f} cycles an event (at {mhz:.0f} "
            "MHz)")


def sweep(args: list[torch.Tensor], n_cores: int) -> tuple[dict, float]:
    """The grid of ``args`` repeated SWEEP_REPS times, one timed launch."""
    big = [a.repeat(SWEEP_REPS, *([1] * (a.dim() - 1))) for a in args]
    torch.cuda.synchronize()
    return timed(lambda: mc_cell_cuda(*big, n_cores=n_cores))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mc_time: no CUDA device")
    mhz = sm_clock_mhz()
    args, C, keys, n_tasks = paper_grid()
    B = len(keys)
    mc_cell_cuda(*(x[:1] for x in args), n_cores=C)  # build, first launch
    out, grid_ms = timed(lambda: mc_cell_cuda(*args, n_cores=C))
    check(out, keys, n_tasks, "paper grid")
    events = out["n_events"].tolist()
    res = {"card": torch.cuda.get_device_name(0), "sm_mhz": mhz,
           "grid_ms": grid_ms, "grid_events": sum(events), "cells": {}}
    print(f"mc grid: {B} cells at {C} cores, {grid_ms:.1f} ms, "
          f"{sum(events)} events", flush=True)
    for b in paper_rows(events):
        name = f"{keys[b][0]} seed {keys[b][1]}"
        res["cells"][name] = r = time_row(args, C, b, events[b], mhz)
        print(f"mc cell: {name} {describe(r, mhz)}", flush=True)
    out, ms = sweep(args, C)
    n = check(out, keys, n_tasks, "sweep")
    res["sweep"] = {"cells": n, "ms": ms, "cells_per_s": n / ms * 1e3}
    print(f"mc sweep: {n} cells in one launch, {ms:.1f} ms, "
          f"{n / ms * 1e3:.2f} cells/s; {n} of {n} digests equal to the "
          "scalar engine's", flush=True)
    del out, args
    torch.cuda.empty_cache()
    res["long_queue"] = {}
    for name, cell in long_queue_cells():
        one = [torch.from_numpy(a).cuda()
               for a in pack([cell], _bucket(len(cell.tasks)))]
        out = mc_cell_cuda(*one, n_cores=cell.n_cores)  # the outputs
        if not bool(out["ok"].all()):
            sys.exit(f"mc_time: {name}: the cell did not drain")
        r = time_row(one, cell.n_cores, 0, int(out["n_events"][0]), mhz)
        r["digest"] = row_digests(out, [len(cell.tasks)])[0]
        res["long_queue"][name] = r
        print(f"mc long queue: {name} {describe(r, mhz)}; digest "
              f"{r['digest'][:16]}", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
