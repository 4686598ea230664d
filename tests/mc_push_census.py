"""Where the mc_cell kernel's runqueue pushes land, counted on the CPU.

  python tests/mc_push_census.py

Runs ``emulate_cell`` of ``test_torch_mc_design.py`` (the kernel's event
loop, statement for statement) with a census on the paper grid's seed-0
cfs and hybrid cells and on the cells of
``repro_torch.launch.mc_time.long_queue_cells``, and prints for each the
pushes by where they land -- "empty" (an empty queue), "back", "front",
"walked" (in from the back, one dependent load a slot moved: "steps")
or "picked" (the fused pick took the pushed task) -- with the events and
the digest of the outputs, which ``mc_time`` prints for the card's run
of the same cell. Three worker processes; a few minutes.
"""
from __future__ import annotations

import json
import sys
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.launch.mc_time import FIELDS, long_queue_cells  # noqa: E402
from repro_torch.mc import paper_digests as pd  # noqa: E402

KINDS = ("empty", "back", "front", "walked", "picked")


def cells():
    paper = pd.paper_cells(seeds=(0,))
    return [(f"{c.policy} seed 0", c) for c in paper[1:]] + \
        long_queue_cells()


def census_of(named):
    import torch
    torch.set_num_threads(1)
    from test_torch_mc_design import emulate
    name, cell = named
    census = Counter()
    out = emulate(cell.policy, cell.n_cores, cell.tasks, cell.kw, census)
    digest = pd.cell_digest([SimpleNamespace(
        tid=i, **{k: out[k][i] for k in FIELDS})
        for i in range(len(cell.tasks))])
    return name, out["n_events"], out["ok"], dict(census), digest


def main() -> None:
    res = {}
    with ProcessPoolExecutor(max_workers=3) as pool:
        for name, events, ok, c, digest in pool.map(census_of, cells()):
            pushes = sum(c.get(k, 0) for k in KINDS)
            shares = ", ".join(f"{k} {c.get(k, 0)} "
                               f"({c.get(k, 0) / max(pushes, 1):.4f})"
                               for k in KINDS)
            walk = c.get("steps", 0) / max(c.get("walked", 0), 1)
            print(f"{name}: {events} events, ok {ok}, {pushes} pushes: "
                  f"{shares}; {c.get('steps', 0)} slots walked, "
                  f"{walk:.2f} a walk; digest {digest[:16]}", flush=True)
            res[name] = dict(events=events, ok=ok, pushes=pushes, **c,
                             digest=digest)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
