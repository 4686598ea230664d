"""How far the serving path through the kernels is from the same path
through their plain versions, by depth, on the card.

  PYTHONPATH=src python -m repro_torch.launch.path_check --arch zamba2-1.2b \\
      --layers 6 12 24 38

Builds ``--arch`` at full width with f32 random weights (seed 0) and, for
each depth N of ``--layers``, runs the model's first N layers (and its
shared block; the same weights) twice: through :mod:`..kernels.ops` and
through :mod:`..kernels.plain`, a prefill of 200 tokens and 4
teacher-forced decode steps. It prints, per step, max |kernel - plain|
of the logits over max |plain|. Both paths round at 2^-24; the distance
is how far the network amplifies that rounding over N layers, which
sets the depth at which a logits tolerance can still tell a kernel
fault (``chip_smoke.py`` uses it for its path check).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..configs.base import ModelConfig
from ..kernels import ops, plain
from ..models import LM
from ..params import init_params

PROMPT, STEPS, SEED = 200, 4, 0


def depth_cut(cfg: ModelConfig, params: dict, n_layers: int
              ) -> tuple[ModelConfig, dict]:
    """The model's first ``n_layers`` layers (and its shared block), on the
    same weights: (config, parameter subset)."""
    if n_layers >= cfg.n_layers:
        return cfg, params
    cut = cfg.with_(n_layers=n_layers)
    names = {n for n, _ in LM(cut, device="meta").named_parameters()}
    return cut, {n: t for n, t in params.items() if n in names}


def path_logits(cfg: ModelConfig, params: dict, kernels,
                toks: torch.Tensor) -> list:
    """f32 logits of a prefill of ``PROMPT`` tokens and ``STEPS``
    teacher-forced decode steps; ``toks`` is (1, PROMPT + STEPS)."""
    lm = LM.from_params(cfg, params, kernels=kernels)
    dev = toks.device
    with torch.inference_mode():
        logits, cache = lm.prefill(toks[:, :PROMPT], PROMPT + STEPS)
        out = [logits.float()]
        for i in range(STEPS):
            pos = torch.tensor([PROMPT + i], device=dev)
            logits, cache = lm.decode_step(toks[:, PROMPT + i], cache, pos)
            out.append(logits.float())
    return out


def prompt(cfg: ModelConfig, device) -> torch.Tensor:
    rng = np.random.default_rng(SEED + 3)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, PROMPT + STEPS))).to(device)


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max()) / float(b.abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b", choices=ARCHS)
    ap.add_argument("--layers", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_check: needs a CUDA device (on the CPU both "
                         "paths are the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    params = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    toks = prompt(cfg, "cuda")
    for n in args.layers:
        cut, sub = depth_cut(cfg, params, n)
        k32 = path_logits(cut, sub, ops, toks)
        p32 = path_logits(cut, sub, plain, toks)
        dists = " ".join(f"{rel_dist(k, p):.3e}" for k, p in zip(k32, p32))
        print(f"{cfg.name} {cut.n_layers} of {cfg.n_layers} layers, f32 "
              f"|kernel - plain| / max |plain| by step: {dists}", flush=True)


if __name__ == "__main__":
    main()
