"""Parallel experiment runner: policy x dispatcher x fleet-size grids
(own copy of ``repro.cluster.sweep``).

Every cell is an independent ``ClusterSim`` run, so the grid is
embarrassingly parallel; ``run_sweep`` fans cells out over a pool of
spawned processes. Workers regenerate the workload from its
``TraceSpec`` (cheap, deterministic) instead of pickling task lists
across process boundaries. ``backend="torch"`` instead batches the cells
inside the Monte-Carlo regime (single nodes and flat ``round_robin`` /
``random`` fleets, no containers) into ``mc_cell`` launches on the card.

CLI (its default backend is ``torch``, the card; ``--device cpu`` runs
the kernel's plain version, ``--backend python`` the scalar engine)::

    python -m repro_torch.cluster.sweep --nodes 2,4 --policies cfs,hybrid \
        --dispatchers random,round_robin --minutes 1

Past one machine, the same grid shards deterministically over hosts
(``--shard i/n`` runs the i-th 1/n slice; ``--merge`` folds the
per-shard ``--out`` files back into one canonical artifact)::

    python -m repro_torch.cluster.sweep --preset heavy_traffic \
        --shard 0/2 --out ht0.json   # host A
    python -m repro_torch.cluster.sweep --preset heavy_traffic \
        --shard 1/2 --out ht1.json   # host B
    python -m repro_torch.cluster.sweep --merge ht0.json ht1.json \
        --out heavy_traffic.json
"""
from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing as mp
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import TYPE_CHECKING, Optional, Union

import torch

from ..core.containers import ContainerSpec
from ..traces.azure import TraceSpec
from .dispatch import DISPATCHERS

if TYPE_CHECKING:
    from ..scenario import Scenario


@dataclass(frozen=True)
class Cell:
    """One grid point; fully describes a reproducible cluster run.

    A cell is now sugar over the Scenario API: ``to_scenario()`` is the
    single translation and ``run_cell`` just executes it. ``workload``
    selects the stream — ``"azure"`` (the calibrated trace) or
    ``"llm"`` (model replicas as functions; ``model`` picks the
    registry arch and ``containers`` its keep-alive policy).
    """
    node_policy: str
    dispatcher: str
    n_nodes: int
    cores_per_node: int = 16
    load_scale: float = 1.0
    minutes: int = 1
    invocations_per_min: float = 1500.0
    n_functions: int = 80
    seed: int = 0
    # Container lifecycle layer: "off" | "fixed" | "histogram".
    containers: str = "off"
    container_capacity_mb: float = 4096.0
    keepalive_ms: float = 30_000.0
    # Workload kind: "azure" | "llm".
    workload: str = "azure"
    model: str = "deepseek-7b"
    # Failure-domain axes: "off" keeps the flat
    # fleet; "zoned" places n_nodes across 2 zones with a std/spot SKU
    # mix (n_nodes must be even). retry="on" attaches the default
    # backoff policy for chaos-lost work.
    topology: str = "off"
    retry: str = "off"
    # Cost-model substrate axes: pricing is a
    # PRICINGS preset name; cost_model is "static" | "learned". The
    # defaults keep cells bit-identical to the pre-CostModel grid.
    pricing: str = "default"
    cost_model: str = "static"

    def to_scenario(self) -> "Scenario":
        from ..scenario import (FleetSpec, PolicySpec, ResilienceSpec,
                                Scenario, WorkloadSpec)
        trace = TraceSpec(minutes=self.minutes,
                          invocations_per_min=self.invocations_per_min,
                          n_functions=self.n_functions, seed=self.seed)
        containers = None
        if self.workload == "llm":
            from ..serving.llm import LLMSpec
            wl = WorkloadSpec(kind="llm", trace=trace,
                              load_scale=self.load_scale,
                              llm=LLMSpec(
                                  model=self.model,
                                  keepalive_ms=self.keepalive_ms,
                                  container_policy=self.containers))
            # containers stay None: the llm workload derives its own
            # spec (cold = weight-load + compile) inside run.
        else:
            wl = WorkloadSpec(kind=self.workload, trace=trace,
                              load_scale=self.load_scale)
            if self.containers != "off":
                containers = ContainerSpec(
                    policy=self.containers,
                    capacity_mb=self.container_capacity_mb,
                    keepalive_ms=self.keepalive_ms)
        # dispatcher="none" selects the single-node engine path (no
        # ClusterSim).
        dispatcher = None if self.dispatcher == "none" else self.dispatcher
        topology = None
        if self.topology == "zoned":
            from .topology import TopologySpec
            if self.n_nodes % 2:
                raise ValueError("topology='zoned' needs an even "
                                 f"n_nodes, got {self.n_nodes}")
            topology = TopologySpec(
                zones=("z0", "z1"), racks_per_zone=self.n_nodes // 2,
                nodes_per_rack=1, sku_pattern=("std", "spot"))
        elif self.topology != "off":
            raise ValueError(f"unknown topology axis {self.topology!r}")
        if self.retry not in ("off", "on"):
            raise ValueError(f"unknown retry axis {self.retry!r}")
        resilience = ResilienceSpec()
        if self.retry == "on":
            from .retry import RetryPolicy
            resilience = ResilienceSpec(retry=RetryPolicy())
        return Scenario(
            workload=wl,
            fleet=FleetSpec(n_nodes=self.n_nodes,
                            cores_per_node=self.cores_per_node,
                            dispatcher=dispatcher,
                            containers=containers, seed=self.seed,
                            topology=topology),
            policy=PolicySpec(name=self.node_policy),
            resilience=resilience,
            pricing=None if self.pricing == "default" else self.pricing,
            cost_model=(None if self.cost_model == "static"
                        else self.cost_model))


def run_cell(cell: Cell) -> dict:
    """Execute one grid point and return its summary row."""
    from ..scenario import run
    res = run(cell.to_scenario())
    row = asdict(cell)
    row.update(res.summary())
    return row


def build_grid(node_policies, dispatchers, n_nodes, load_scales=(1.0,),
               **common) -> list[Cell]:
    return [Cell(node_policy=p, dispatcher=d, n_nodes=n, load_scale=ls,
                 **common)
            for p, d, n, ls in itertools.product(
                node_policies, dispatchers, n_nodes, load_scales)]


def run_sweep(grid: list[Cell], *, parallel: bool = True,
              processes: Optional[int] = None,
              backend: str = "python",
              device: Optional[Union[str, torch.device]] = None
              ) -> list[dict]:
    """Run every cell and return summary rows in grid order.

    ``backend="torch"`` routes cells inside the batched Monte-Carlo
    regime (single node or flat ``round_robin`` / ``random`` fleets, no
    containers: ``repro_torch.mc.dispatch``) through one ``mc_cell``
    launch a shape bucket on ``device`` (None: the card) and everything
    else through the usual per-cell path; rows gain a ``backend`` key
    recording the route, and fallback rows a ``fallback_reason`` counter
    key. Results are identical either way: the batched engine is
    bit-compatible and out-of-regime cells fall back transparently. The
    pool's workers are spawned, never forked, since the batched part may
    already have started CUDA and torch's threads in this process.
    """
    if backend == "torch":
        return _run_sweep_batched(grid, parallel=parallel,
                                  processes=processes, device=device)
    if backend != "python":
        raise ValueError(f"unknown backend {backend!r}")
    if not parallel or len(grid) <= 1:
        return [run_cell(c) for c in grid]
    processes = processes or min(len(grid), os.cpu_count() or 2)
    with mp.get_context("spawn").Pool(processes) as pool:
        return pool.map(run_cell, grid)


def _run_sweep_batched(grid: list[Cell], *, parallel: bool,
                       processes: Optional[int],
                       device: Optional[Union[str, torch.device]]
                       ) -> list[dict]:
    from ..device import resolve_device
    from ..mc.dispatch import reason_key, supported, tasks_supported
    from ..mc.engine import run_scenarios

    resolve_device(device)    # no card: raise before any cell runs

    scs = [c.to_scenario() for c in grid]
    # Per-cell gate refusal keys (None = batched): fallback rows carry
    # theirs as ``fallback_reason`` so a sweep that silently routes
    # most cells to the scalar path never reads as "batched".
    reasons: list[Optional[str]] = []
    for sc in scs:
        why = supported(sc)
        reasons.append(None if why is None else reason_key(why))
    idx = [k for k in range(len(scs)) if reasons[k] is None]
    # Build once here (shared with the kernel via ``prebuilt``) so the
    # dynamic half of the gate can still demote caller-shaped streams.
    prebuilt = []
    for k in idx:
        tasks_meta = scs[k].workload.build()
        why = tasks_supported(tasks_meta[0])
        if why is None:
            prebuilt.append(tasks_meta)
        else:
            reasons[k] = reason_key(why)
    idx = [k for k in idx if reasons[k] is None]

    rows: list[Optional[dict]] = [None] * len(grid)
    if idx:
        batched = run_scenarios([scs[k] for k in idx], prebuilt=prebuilt,
                                device=device)
        for k, res in zip(idx, batched):
            row = asdict(grid[k])
            row.update(res.summary())
            row["backend"] = "torch"
            rows[k] = row
    rest = [k for k in range(len(grid)) if rows[k] is None]
    if rest:
        for k, row in zip(rest, run_sweep([grid[k] for k in rest],
                                          parallel=parallel,
                                          processes=processes)):
            row["backend"] = "python"
            row["fallback_reason"] = reasons[k]
            rows[k] = row
    return rows


def compare_serial(grid: list[Cell],
                   processes: Optional[int] = None) -> dict:
    """Time the same grid serially and in parallel; returns timings and
    the speedup (the sweep-runner acceptance check)."""
    t0 = time.time()
    run_sweep(grid, parallel=False)
    serial_s = time.time() - t0
    t0 = time.time()
    rows = run_sweep(grid, parallel=True, processes=processes)
    parallel_s = time.time() - t0
    return {"serial_s": serial_s, "parallel_s": parallel_s,
            "speedup": serial_s / max(parallel_s, 1e-9), "rows": rows}


def _csv(vals, cast=str):
    return [cast(v) for v in vals.split(",") if v]


# -- sharding: split one grid across machines ---------------------------------

def shard_grid(grid: list[Cell], shard: str) -> list[Cell]:
    """Deterministic cell partition for multi-host sweeps.

    ``shard`` is ``"i/n"``: this invocation runs every cell whose index
    in the (deterministic) grid order is ``i`` mod ``n``. The shards are
    disjoint, cover the grid exactly, and — because ``build_grid`` is a
    pure itertools product — every host computes the same partition from
    the same flags with no coordination. Merge the per-shard ``--out``
    files with ``--merge`` afterwards.
    """
    try:
        i_s, n_s = shard.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"--shard wants 'i/n', got {shard!r}") from None
    if not (n >= 1 and 0 <= i < n):
        raise ValueError(f"shard index {i} out of range for {n} shards")
    return [c for k, c in enumerate(grid) if k % n == i]


def _row_key(row: dict) -> tuple:
    return tuple(str(row.get(k)) for k in (
        "node_policy", "dispatcher", "n_nodes", "load_scale",
        "containers", "seed", "minutes", "workload", "model",
        "topology", "retry", "pricing", "cost_model"))


def merge_rows(paths: list[str]) -> list[dict]:
    """Fold per-shard ``--out`` JSON files back into one artifact's
    rows, canonically ordered: any shard split of the same grid merges
    to the identical row list, and it contains exactly the rows an
    unsharded run produces (the unsharded artifact keeps grid order,
    so compare per cell — as the gate and trend report do — not by
    byte-diffing files)."""
    rows: list[dict] = []
    for p in paths:
        with open(p) as f:
            payload = json.load(f)
        rows.extend(payload["rows"] if isinstance(payload, dict)
                    else payload)
    rows.sort(key=_row_key)
    return rows


def profile_slowest_cell(grid: list[Cell], top: int = 20) -> dict:
    """Time every cell serially, then re-run the slowest one under
    cProfile and print its ``top`` hottest functions (cumulative). One
    command answers "where did my sweep's wall-clock go" — the next
    engine hot spot is whatever this prints first."""
    import cProfile
    import pstats

    timings = []
    for cell in grid:
        t0 = time.time()
        run_cell(cell)
        timings.append((time.time() - t0, cell))
    worst_s, worst = max(timings, key=lambda x: x[0])
    print(f"# slowest cell ({worst_s:.2f}s serial): {worst}",
          file=sys.stderr)
    prof = cProfile.Profile()
    prof.enable()
    row = run_cell(worst)
    prof.disable()
    stats = pstats.Stats(prof, stream=sys.stderr)
    stats.sort_stats("cumulative").print_stats(top)
    return {"slowest_cell": asdict(worst), "serial_s": worst_s,
            "row": row}


# Named grids. ``heavy_traffic`` is the paper-size nightly preset: the
# full 2-minute Azure-like trace crossed with load scales and fleet
# sizes, containers modelled with the Azure-style histogram keep-alive.
PRESETS: dict[str, dict] = {
    "heavy_traffic": {
        "policies": ["cfs", "hybrid"],
        "dispatchers": ["least_loaded", "affinity", "warm_affinity",
                        "cost_aware"],
        "nodes": [4, 8],
        "load_scales": [1.0, 2.0, 4.0],
        "minutes": 2,
        "invocations_per_min": 6221.0,   # paper volume: ~12,442 in 2 min
        "n_functions": 250,
        "cores_per_node": 16,
        "containers": "histogram",
    },
}


SUMMARY_COLS = ("node_policy", "dispatcher", "n_nodes", "load_scale",
                "cost_usd", "cold_start_rate", "warm_hold_usd",
                "p99_slowdown", "util_range")


def print_rows(rows: list[dict], cols=SUMMARY_COLS) -> None:
    """CSV-print summary rows (shared by the sweep CLI and benches).
    Missing columns print empty: single-node cells (dispatcher
    ``"none"``) carry no fleet-only keys like ``util_range``."""
    print(",".join(cols))
    for r in rows:
        print(",".join("" if c not in r
                       else f"{r[c]:.4g}" if isinstance(r[c], float)
                       else str(r[c]) for c in cols))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policies", default="cfs,hybrid")
    ap.add_argument("--dispatchers", default=",".join(sorted(DISPATCHERS)))
    ap.add_argument("--nodes", default="2,4")
    ap.add_argument("--load-scales", default="1.0")
    ap.add_argument("--cores-per-node", type=int, default=16)
    ap.add_argument("--minutes", type=int, default=1)
    ap.add_argument("--invocations-per-min", type=float, default=1500.0)
    ap.add_argument("--n-functions", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--containers", default="off",
                    choices=("off", "fixed", "histogram"),
                    help="container lifecycle layer / keep-alive policy")
    ap.add_argument("--container-capacity-mb", type=float, default=4096.0)
    ap.add_argument("--keepalive-ms", type=float, default=30_000.0)
    ap.add_argument("--topology", default="off", choices=("off", "zoned"),
                    help="zoned: place nodes across 2 zones with a "
                         "std/spot SKU mix (needs even --nodes)")
    ap.add_argument("--retry", default="off", choices=("off", "on"),
                    help="attach the default backoff retry policy for "
                         "chaos-lost work")
    ap.add_argument("--pricing", default="default",
                    help="PricingSpec preset every cell bills with "
                         "(repro_torch.costmodel.PRICINGS; default keeps the "
                         "historical constants bit-identically)")
    ap.add_argument("--cost-model", default="static",
                    choices=("static", "learned"),
                    help="cost model threaded into llm pricing, "
                         "cost_aware dispatch, admission and pre-warm")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="named grid (overrides the grid-shape flags)")
    ap.add_argument("--shard", default=None, metavar="i/n",
                    help="run only this deterministic 1/n slice of the "
                         "grid (fan a sweep out over hosts; recombine "
                         "the per-shard --out files with --merge)")
    ap.add_argument("--merge", nargs="+", default=None, metavar="JSON",
                    help="merge per-shard --out files into --out and "
                         "exit (no cells are run)")
    ap.add_argument("--backend", default="torch",
                    choices=("python", "torch"),
                    help="torch: batch in-regime cells (single-node or "
                         "flat round_robin/random fleets, no "
                         "containers) into one mc_cell launch a shape "
                         "bucket on --device; out-of-regime cells fall "
                         "back per cell. python: the scalar engine")
    ap.add_argument("--device", default=None,
                    help="the torch backend's device (default: the card; "
                         "cpu runs the kernel's plain version)")
    ap.add_argument("--serial", action="store_true",
                    help="disable the multiprocessing pool")
    ap.add_argument("--compare-serial", action="store_true",
                    help="time serial vs parallel and report the speedup")
    ap.add_argument("--profile", action="store_true",
                    help="run serially, then print a cProfile top-20 of "
                         "the slowest cell (engine hot-spot hunting)")
    ap.add_argument("--out", default=None, help="write rows as JSON here")
    args = ap.parse_args(argv)

    if args.merge:
        rows = merge_rows(args.merge)
        print_rows(rows)
        if not args.out:
            ap.error("--merge needs --out for the combined artifact")
        with open(args.out, "w") as f:
            json.dump({"meta": {"merged_from": args.merge}, "rows": rows},
                      f, indent=2)
        print(f"# merged {len(args.merge)} shard files "
              f"({len(rows)} rows) -> {args.out}", file=sys.stderr)
        return

    if args.preset:
        p = PRESETS[args.preset]
        grid = build_grid(
            p["policies"], p["dispatchers"], p["nodes"], p["load_scales"],
            cores_per_node=p["cores_per_node"], minutes=p["minutes"],
            invocations_per_min=p["invocations_per_min"],
            n_functions=p["n_functions"], seed=args.seed,
            containers=p["containers"],
            container_capacity_mb=args.container_capacity_mb,
            keepalive_ms=args.keepalive_ms,
            topology=args.topology, retry=args.retry,
            pricing=args.pricing, cost_model=args.cost_model)
    else:
        grid = build_grid(
            _csv(args.policies), _csv(args.dispatchers),
            _csv(args.nodes, int), _csv(args.load_scales, float),
            cores_per_node=args.cores_per_node, minutes=args.minutes,
            invocations_per_min=args.invocations_per_min,
            n_functions=args.n_functions, seed=args.seed,
            containers=args.containers,
            container_capacity_mb=args.container_capacity_mb,
            keepalive_ms=args.keepalive_ms,
            topology=args.topology, retry=args.retry,
            pricing=args.pricing, cost_model=args.cost_model)

    if args.shard:
        full = len(grid)
        grid = shard_grid(grid, args.shard)
        print(f"# shard {args.shard}: {len(grid)}/{full} cells",
              file=sys.stderr)

    if args.profile:
        profile_slowest_cell(grid)
        return

    meta = {}
    if args.compare_serial:
        meta = compare_serial(grid)
        rows = meta.pop("rows")
        print(f"# serial {meta['serial_s']:.2f}s  "
              f"parallel {meta['parallel_s']:.2f}s  "
              f"speedup {meta['speedup']:.2f}x", file=sys.stderr)
    else:
        rows = run_sweep(grid, parallel=not args.serial,
                         backend=args.backend, device=args.device)

    print_rows(rows)
    if args.out:
        payload = {"meta": meta, "rows": rows}
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)


if __name__ == "__main__":
    main()
