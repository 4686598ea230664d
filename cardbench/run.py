"""Runs one cell of ``BENCHMARK.json`` once and prints its result as the
last line of standard output (one JSON object), the numbers its check
compared, each beside its limit, as the last lines of standard error.

  python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch`` beside
``cardbench/``. It needs as many CUDA cards as the cell asks for, and
prints no result and exits with 1 without them, or when a module named
``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package) is loaded
once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench.harness import load_cell, run_cell
    cell = load_cell(args.workload, ROOT)
    import torch
    want = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"cardbench: {args.workload} needs {want} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the run loaded {bad}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
