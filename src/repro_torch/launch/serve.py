"""Serving entry point of the port: the real model under the hybrid slot
scheduler (engine mode of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b --full

Serves the reduced (smoke) config of ``--arch`` with random bf16 weights
(seed 0): 8 requests of 8 prompt tokens, ``max_new = 4 + 2 * rid``.
With ``--full`` it serves the arch's published config instead, at full
width and depth (gemma3-27b: 62 layers, 59.4 GB of weights on one card).
The trace-driven gateway mode needs the simulator, which the port has
not copied yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke
from ..device import resolve_device
from ..params import init_params
from ..serving import LiveRequest, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--mode", default="engine", choices=["engine"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the smoke")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke)(args.arch)
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
