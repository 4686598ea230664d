"""Serving entry point of the port: the paper's hybrid scheduler over
device slots (``repro.launch.serve``'s two modes).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway

engine (the default) serves the reduced (smoke) config of ``--arch``
(deepseek-7b unless named) with random bf16 weights (seed 0): 8 requests
of 8 prompt tokens, ``max_new = 4 + 2 * rid``. With ``--full`` it serves
the arch's published config instead, at full width and depth (gemma3-27b:
62 layers, 59.4 GB of weights on one card).

gateway is the trace-driven slot-scheduler comparison (fifo, cfs and
hybrid) for ``--arch`` (rwkv6-1.6b unless named) with billing: one JSON
row a policy, then the hybrid's saving against the CFS analogue. It is
host simulation, touches no device and ignores ``--device``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke
from ..device import resolve_device
from ..params import init_params
from ..serving import (LiveRequest, ServingEngine, requests_from_trace,
                       run_gateway)
from ..traces import TraceSpec

DEFAULT_ARCH = {"engine": "deepseek-7b", "gateway": "rwkv6-1.6b"}


def gateway(arch: str, minutes: int, rate: float, slots: int) -> None:
    """Bill the arch's trace-driven requests under fifo, cfs and hybrid."""
    cfg = get_config(arch)
    trace = TraceSpec(minutes=minutes, invocations_per_min=rate)
    reqs = requests_from_trace(cfg, trace)
    rows = []
    for policy in ("fifo", "cfs", "hybrid"):
        r = run_gateway(cfg, policy, requests=reqs, n_slots=slots)
        s = r.summary()
        rows.append({k: s[k] for k in
                     ("policy", "n", "p99_execution_s",
                      "p99_response_s", "p99_turnaround_s",
                      "cost_usd", "preemptions")})
        print(json.dumps(rows[-1]))
    cfs = next(r for r in rows if r["policy"] == "cfs")
    hyb = next(r for r in rows if r["policy"] == "hybrid")
    print(f"[serve] {arch}: hybrid saves "
          f"{cfs['cost_usd'] / max(hyb['cost_usd'], 1e-9):.1f}x vs "
          f"CFS-analogue")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCHS)
    ap.add_argument("--mode", default="engine",
                    choices=["engine", "gateway"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the smoke")
    ap.add_argument("--minutes", type=int, default=1)
    ap.add_argument("--rate", type=float, default=3000.0)
    ap.add_argument("--slots", type=int, default=50)
    args = ap.parse_args(argv)
    arch = args.arch or DEFAULT_ARCH[args.mode]

    if args.mode == "gateway":
        gateway(arch, args.minutes, args.rate, args.slots)
        return

    device = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke)(arch)
    params = init_params(cfg, seed=0, device=device,
                         dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, n_slots=4, n_fifo=2, max_len=64,
                        initial_limit_ms=40.0, device=device)
    rng = np.random.default_rng(1)
    for rid in range(8):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 8)))
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0, tokens=toks,
                               max_new=4 + rid * 2))
    for r in eng.run():
        print(f"req {r.rid}: tokens={len(r.generated)} "
              f"exec={r.execution_ms():.1f}ms preempt={r.preemptions} "
              f"cost=${r.cost_usd():.2e}")


if __name__ == "__main__":
    main()
