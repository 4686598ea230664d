"""The readings a cell's logit-gap limit is set from, on the card: for each
seed one window of the cell (the benchmark's own set-up, traffic and
sample), then the widest gap of the program's served tokens below the
float32 reference's best (the lower reading: the largest over the seeds),
and the control's: at the same positions, the gap of the token that the
reference computed in float8 e4m3 (every product's operands rounded, the
precision below the bfloat16 the configuration serves in) puts first
(the upper reading: the smallest over the seeds); each as the widest gap
and the mean gap over the sample's tokens. With ``--faults``, on the same
seeds a window more for each fault of ``cardbench/faults.py`` named,
planted in the program: its gaps, its ``sched_mismatch`` and whether the
cell's check comes out false. The benchmark's runs do not run it.

  python3 cardbench/control.py --workload deepseek-7b.conv.closed \\
      --seeds 101 102 103 --seconds 51 --control 3 \\
      --faults state_unchanged wrong_lane

One process: the weights are drawn into the same buffers for each seed
and an engine is built for each window. One JSON line a window.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, control: bool, weights=None,
             device="cuda", port=None) -> tuple[dict, object]:
    from cardbench import check
    from cardbench.harness import serve_cell
    rec, programs, weights, prompts, _ = serve_cell(
        cell, seed, seconds, False, device=device, port=port,
        weights=weights)
    g, low, picked = check.gaps(rec, programs, weights.params, prompts,
                                control)
    out = {"seed": seed, "program": check.numbers(g),
           "control": check.numbers(low) if control else None,
           "requests": len(picked),
           "moved": sum(len(set(rec.reqs[rid].lanes)) > 1 for rid in picked),
           "tokens": check.n_tokens(g)}
    return out, weights


def fault_readings(cell, seed: int, seconds: float, fault: str,
                   weights=None, device="cuda", port=None) -> tuple[dict,
                                                                   object]:
    from cardbench import check
    from cardbench.faults import FAULTS
    from cardbench.harness import serve_cell
    rec, programs, weights, prompts, _ = serve_cell(
        cell, seed, seconds, False, device=device, port=port,
        weights=weights, faults=FAULTS[fault])
    g, _, picked = check.gaps(rec, programs, weights.params, prompts)
    got = dict(check.numbers(g), sched_mismatch=check.mismatch(rec, programs))
    limits = dict(cell.config["limits"], sched_mismatch=0)
    caught = any(got[k] is None or got[k] > v for k, v in limits.items())
    moved = sum(len(set(rec.reqs[rid].lanes)) > 1 for rid in picked)
    return {"seed": seed, "fault": fault, "fault_reads": got,
            "caught": caught, "requests": len(picked), "moved": moved,
            "tokens": check.n_tokens(g)}, weights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="run the control on the first this many seeds")
    ap.add_argument("--faults", nargs="*", default=[],
                    help="faults to plant, each on the control's seeds")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench.harness import load_cell
    cell = load_cell(args.workload, ROOT)
    weights = None
    for i, seed in enumerate(args.seeds):
        out, weights = readings(cell, seed, args.seconds, i < args.control,
                                weights)
        print(json.dumps(out), flush=True)
        for fault in args.faults if i < args.control else ():
            out, weights = fault_readings(cell, seed, args.seconds, fault,
                                          weights)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
