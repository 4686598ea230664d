"""The knee of an open-loop traffic mix on a configuration: the highest
arrival rate the engine sustains, found once, when a cell's rate is
chosen, and not by the benchmark's runs. For each rate (and arrival
order, and seed) one window at that rate; printed: the requests due and
finished, those still in the engine at the window's end, the tokens read
a second, and the TTFT median and 95th percentile (due to first token; a
request still waiting counts its wait so far).

  python3 cardbench/sweep.py --config deepseek-7b --traffic code_rate \\
      --rates 2 3 4 5 6 --seconds 30 --seeds 11 12

One process: the weights are drawn once, an engine is built a window.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--orders", nargs="+", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench.harness import make_cell, serve_cell
    from cardbench.readings import percentile, waited
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = make_cell({"name": f"{args.config}.{args.traffic}",
                      "config": args.config, "traffic": args.traffic,
                      "chips": 1}, bench, ROOT)
    weights = None
    for order in args.orders or [base.traffic["order"]]:
        for rate in args.rates:
            for seed in args.seeds:
                cell = copy.deepcopy(base)
                cell.traffic["arrivals"]["rate_per_s"] = rate
                cell.traffic["order"] = order
                rec, programs, weights, _, _ = serve_cell(
                    cell, seed, args.seconds, False, weights=weights)
                ttft = waited(rec, "t_first")
                done = sum(p.completion_ms is not None
                           for p in programs.values())
                print(json.dumps({
                    "order": order, "rate": rate, "seed": seed,
                    "due": len(ttft), "finished": done,
                    "in_engine_at_close": len(programs) - done,
                    "tokens_per_s": sum(rec.start <= t <= rec.end
                                        for t in rec.tokens) / rec.seconds,
                    "ttft_p50_ms": 1e3 * percentile(ttft, 50),
                    "ttft_p95_ms": 1e3 * percentile(ttft, 95),
                    "preemptions": sum(p.preemptions
                                       for p in programs.values())}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
