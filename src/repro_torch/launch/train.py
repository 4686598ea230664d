"""Training launcher of the port: AdamW, per-layer remat, microbatches,
checkpoint/restart in JAX's format, a straggler watchdog and the
resumable data pipeline (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --full --layers 12 \\
      --steps 5 --batch 4 --seq 4096 --microbatches 2 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --full --steps 3 --batch 4 --seq 4096 --microbatches 2 --lr 3e-4

Runs on the card unless ``--device cpu``; the arch's smoke config
unless ``--full`` (its published widths; ``--layers`` cuts the depth:
deepseek-7b's 30 layers need 111 GB of f32 state, zamba2-1.2b (17.7 GB)
and rwkv6-1.6b (23.7 GB) train uncut). Every family trains. Parameters
are f32 masters drawn from ``TrainConfig.seed``, cast to bf16 where
used; on the card every norm, attention and scan (``ssm_scan``,
``rwkv6_scan``) runs the hand-written kernels forward and backward.
Logs step, loss, lr, grad norm and seconds as JAX's launcher does, and
resumes from the newest checkpoint in ``--ckpt-dir`` whose hash holds.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, TrainConfig, get_config, get_smoke
from ..device import resolve_device
from ..distributed.elastic import StepWatchdog
from ..models import LM
from ..params import init_params
from ..training import (SyntheticLM, init_opt_state, load_train_state,
                        make_train_step, state_like, train_state)

def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the plain path")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches)
    params = init_params(cfg, seed=tcfg.seed, device=dev,
                         dtype=torch.float32)
    lm = LM.from_params(cfg, params, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e6:.1f} M parameters (f32 masters, "
          f"bf16 compute) on {dev}", flush=True)
    opt = init_opt_state(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=tcfg.seed, device=dev)
    step_fn = make_train_step(lm, tcfg)
    watchdog = StepWatchdog()

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2)
        latest, state = ckpt.restore_latest(state_like(cfg))
        if latest is not None:
            opt, data_state = load_train_state(state, lm, opt)
            data.load_state(data_state)
            start = latest
            print(f"[train] resumed from step {latest}", flush=True)

    t_run = time.time()
    for step in range(start, args.steps):
        batch = data.next_batch()
        t0 = time.time()
        opt, metrics = step_fn(opt, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.time() - t0
        if watchdog.record(dt):
            print(f"[train] straggler step {step}: {dt:.2f}s", flush=True)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, train_state(lm, opt, data.state_dict()))
    if ckpt:
        ckpt.save(args.steps, train_state(lm, opt, data.state_dict()))
        ckpt.wait()
    print(f"[train] done in {time.time() - t_run:.1f}s", flush=True)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated(dev)} B allocated, "
              f"{torch.cuda.max_memory_reserved(dev)} B reserved, of "
              f"{torch.cuda.get_device_properties(dev).total_memory} B; "
              f"{total - free - torch.cuda.memory_reserved(dev)} B held "
              "outside the caching allocator", flush=True)


if __name__ == "__main__":
    main()
