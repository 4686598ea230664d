"""The paper's FIFO / CFS / hybrid grid and the scalar engine's answer
for it, as sha256 digests a cell.

The grid is ``configs.paper.CONFIG``: one node of 50 cores, the default
``TraceSpec`` (2 minutes, 250 functions, 6221 invocations a minute,
12,643 tasks at seed 0) at seeds 0-3 and load 1.0, under fifo, cfs and
the hybrid (25 FIFO cores, a 1633 ms time limit). Each digest was
computed from the JAX package's scalar event loop, ``repro.run``; the
batched engine must give the same bits. Regenerate them with

    PYTHONPATH=src python tests/test_torch_mc_design.py
"""
from __future__ import annotations

import hashlib
from dataclasses import replace
from typing import Sequence

from ..configs.paper import CONFIG
from ..core.events import Task
from ..traces.workload import generate_workload
from .engine import Cell

SEEDS = (0, 1, 2, 3)
POLICIES = ("fifo", "cfs", "hybrid")


def paper_kw(policy: str) -> dict:
    """The hybrid's knobs from CONFIG (none for fifo and cfs)."""
    if policy != "hybrid":
        return {}
    return {"n_fifo": CONFIG.sched.n_fifo,
            "time_limit_ms": CONFIG.sched.time_limit_ms}


def paper_cells(seeds: Sequence[int] = SEEDS) -> list[Cell]:
    """The grid, seed-major, one trace generation a seed."""
    cells = []
    for seed in seeds:
        tasks = generate_workload(replace(CONFIG.trace, seed=seed)).tasks
        cells += [Cell(p, CONFIG.sched.n_cores, tasks, paper_kw(p))
                  for p in POLICIES]
    return cells


def cell_digest(tasks: Sequence[Task]) -> str:
    """sha256 over the tasks in tid order: repr of completion, first_run
    and cpu_time, then preemptions, ctx_switches and migrations."""
    h = hashlib.sha256()
    for t in sorted(tasks, key=lambda t: t.tid):
        h.update(f"{float(t.completion)!r} {float(t.first_run)!r} "
                 f"{float(t.cpu_time)!r} {int(t.preemptions)} "
                 f"{int(t.ctx_switches)} {int(t.migrations)}\n".encode())
    return h.hexdigest()


# (policy, seed) -> digest of the scalar engine's tasks
DIGESTS = {
    ('fifo', 0): "37aedc1dd10987b456df56d54943cca2477e3e115e65f9ec68aef4fc532079e4",
    ('cfs', 0): "ea05d1c50294d6a9ecc8e1b8de757270cbcc1deae9882b85a8f70c0dbca536be",
    ('hybrid', 0): "77443929e7ee548c4e6418fed09e689297b3ee26d063e0aaafff64fe64e4e48f",
    ('fifo', 1): "61c8d203c0591138d0cd30351c02d09c652c790dd5ccfdb2c1ae085149feea0d",
    ('cfs', 1): "c0a3a1a4cef0c7e4319c9f720bc350b205934a582b6b4de3e6ed62e052752ea6",
    ('hybrid', 1): "a16ea09f37d43f56eae79dc011b5dd6637973079f7caa2f458a8da0acbb2b5e9",
    ('fifo', 2): "8b6ab85119533f638bb94e98681379a5da0b722f96ffd0d131c6324f4bfc269f",
    ('cfs', 2): "cb6461233b3134cbb666771b84523afc64b33a7f4d491bdc12fa0053b5615a2a",
    ('hybrid', 2): "8f53c1718bb357f42c6ab5f46dcd9960f558b604ae6cba5583301ed8bedd95be",
    ('fifo', 3): "812b273e580337b7d0eaec623238a5a7b6f497b131f7f5274eaaaf294cb1ba0a",
    ('cfs', 3): "9d2367914c6c39a4854425bb33fe920dc5169881732ed9c539e6d30906a0224a",
    ('hybrid', 3): "44b0eaae3a8aa4ec688167ff83772cd77b37b7bb4f7cd9dac0e148d6b3dd6693",
}
