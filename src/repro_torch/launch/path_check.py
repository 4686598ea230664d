"""How far the serving path through the kernels is from the same path
through their plain versions, by depth, on the card.

  PYTHONPATH=src python -m repro_torch.launch.path_check --arch zamba2-1.2b \\
      --layers 6 12 24 38

Builds ``--arch`` at full width with bf16 random weights (seed 0) and, for
each depth N of ``--layers``, runs the model's first N layers (and its
shared block; the same weights), cast to f32 (:func:`f32_twin`, the
weights of ``chip_smoke.py``'s f32 checks), twice: through
:mod:`..kernels.ops` and through :mod:`..kernels.plain`, a prefill of
200 tokens and 4 teacher-forced decode steps. It prints, per step, max
|kernel - plain| of the logits over max |plain|. Both paths round at
2^-24; the distance is how far the network amplifies that rounding over
N layers, which sets the depth at which a logits tolerance can still
tell a kernel fault (``chip_smoke.py`` uses it for its path check). For
a vision or audio arch it also prints the same distance for a prefill
of the modality frontend's embeddings of a 600-token prompt
(``chip_smoke.py``'s frontend phase).

For a model with experts it also prints the route agreement of the two
paths: over every MoE layer, token and call, how many tokens chose
another set of experts, how many assignments were dropped on one path
only, the smallest margin between a token's K-th and (K+1)-th router
probability, and where a choice first moved. A moved choice moves the
logits by a gate-sized amount, not by rounding; where one first moves,
only rounding separates the paths, so its margin must be of the order
of the rounding. Two measurements that depart from the model tell route
flips and rounding apart: the kernel path forced onto the plain path's
routes, and both paths with the expert activations left unrounded.
"""
from __future__ import annotations

import argparse
from contextlib import contextmanager, nullcontext
from typing import Optional

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..configs.base import ModelConfig
from ..kernels import ops, plain
from ..models import LM, layers
from ..models.frontends import input_embeds_for
from ..params import init_params

PROMPT, FRONTEND_PROMPT, STEPS, SEED = 200, 600, 4, 0


def depth_cut(cfg: ModelConfig, params: dict, n_layers: int
              ) -> tuple[ModelConfig, dict]:
    """The model's first ``n_layers`` layers (and its shared block), on the
    same weights: (config, parameter subset)."""
    if n_layers >= cfg.n_layers:
        return cfg, params
    cut = cfg.with_(n_layers=n_layers)
    names = {n for n, _ in LM(cut, device="meta").named_parameters()}
    return cut, {n: t for n, t in params.items() if n in names}


def f32_twin(cfg: ModelConfig, params: dict, n_layers: int
             ) -> tuple[ModelConfig, dict]:
    """The first ``n_layers`` layers of a parameter set (:func:`depth_cut`)
    cast to f32. The cast of bf16 is exact, so the twin holds the same
    weights as the set it came from, and no second draw of the model is
    needed (one that would not fit beside the first: moonshot-v1-16b-a3b
    takes ~110 GB in f32). f32 leaves are shared, not copied."""
    cut, sub = depth_cut(cfg, params, n_layers)
    return cut, {n: t.float() for n, t in sub.items()}


def path_logits(cfg: ModelConfig, params: dict, kernels,
                toks: torch.Tensor, routes: Optional[list] = None,
                forced: Optional[list] = None,
                frontend: bool = False) -> list:
    """f32 logits of a prefill of S tokens and ``STEPS`` teacher-forced
    decode steps; ``toks`` is (1, S + STEPS). With ``frontend``, the
    prefill takes the modality frontend's embeddings of the prompt
    (``input_embeds_for``; the vision stub draws its patches from a
    generator seeded with SEED + 5, the same in every run). With
    ``routes`` a list, appends each MoE layer's routing records to it
    (one list a layer, one record a call: ``layers.moe``). ``forced``,
    the ``routes`` of another run, is a measurement, not the model:
    every call of every MoE layer takes that run's experts (its gates
    are this run's probabilities of them)."""
    lm = LM.from_params(cfg, params, kernels=kernels)
    moes = [layer.moe for layer in lm.layers if hasattr(layer, "moe")]
    if routes is not None:
        for p in moes:
            p.routes = []
            routes.append(p.routes)
    dev, S = toks.device, toks.shape[1] - STEPS
    with torch.inference_mode(), (
            routed_to(moes, forced) if forced else nullcontext()):
        embeds = None
        if frontend:
            gen = torch.Generator(device=dev).manual_seed(SEED + 5)
            embeds = input_embeds_for(cfg, params, toks[:, :S], gen)
        logits, cache = lm.prefill(toks[:, :S], S + STEPS, embeds=embeds)
        out = [logits.float()]
        for i in range(STEPS):
            pos = torch.tensor([S + i], device=dev)
            logits, cache = lm.decode_step(toks[:, S + i], cache, pos)
            out.append(logits.float())
    return out


@contextmanager
def patched(name: str, fn):
    """``layers.<name>`` replaced by ``fn`` inside the block (``moe`` looks
    its pieces up on the module at every call)."""
    kept = getattr(layers, name)
    setattr(layers, name, fn)
    try:
        yield kept
    finally:
        setattr(layers, name, kept)


def routed_to(moes: list, routes: list):
    """Inside the block, call c of ``moes[i]`` takes the experts of
    ``routes[i][c]`` in place of its own top K."""
    queues = {id(p): [r["eids"] for r in rs] for p, rs in zip(moes, routes,
                                                               strict=True)}
    route = layers.route

    def forced(p, h, cfg):
        probs, _, _ = route(p, h, cfg)
        eids = queues[id(p)].pop(0)
        return probs, eids, layers.renormalise(probs.gather(-1, eids))

    return patched("route", forced)


def by_step(a: list, b: list) -> str:
    return " ".join(f"{rel_dist(x, y):.3e}" for x, y in zip(a, b))


def route_agreement(a: list, b: list, n_experts: int) -> dict:
    """Routes of two runs of one model (``path_logits``' ``routes``):
    ``tokens`` token choices compared (layers x calls x tokens),
    ``moved`` tokens whose set of experts differs, ``dropped`` (token,
    expert) assignments dropped on one path only, ``margin`` the
    smallest K-th minus (K+1)-th probability on path ``b``. ``first``:
    where a choice first moved in the order the runs compute (call, then
    layer), as (call, layer, tokens moved there, their largest margin on
    b and that margin over the K-th probability), or None. Choices moved
    there can only come from rounding; later ones may follow from
    them."""
    out = dict(tokens=0, moved=0, dropped=0, margin=float("inf"),
               first=None)
    for call in range(len(b[0]) if b else 0):
        for layer, (la, lb) in enumerate(zip(a, b, strict=True)):
            ra, rb = la[call], lb[call]
            chosen, dropped = [], []
            for r in (ra, rb):
                eids, slots = r["eids"], r["slots"].view(r["eids"].shape)
                onehot = torch.zeros(*eids.shape[:-1], n_experts,
                                     dtype=torch.bool, device=eids.device)
                chosen.append(onehot.scatter(-1, eids, True))
                drop = slots == n_experts * r["capacity"]
                dropped.append(onehot.scatter(-1, eids, drop))
            moved = (chosen[0] != chosen[1]).any(-1)
            n = int(moved.sum())
            out["tokens"] += moved.numel()
            out["moved"] += n
            out["dropped"] += int((dropped[0] != dropped[1]).sum())
            out["margin"] = min(out["margin"], float(rb["margin"].min()))
            if n and out["first"] is None:
                rel = rb["margin"][moved] / rb["kth"][moved]
                out["first"] = (call, layer, n,
                                float(rb["margin"][moved].max()),
                                float(rel.max()))
    return out


def route_line(agree: dict) -> str:
    first = agree["first"]
    where = ("none moved" if first is None else
             f"first moved in call {first[0]} (0: the prefill), layer "
             f"{first[1]}: {first[2]} token(s) at margins up to "
             f"{first[3]:.3e}, {first[4]:.3e} of the K-th probability")
    return (f"{agree['moved']} of {agree['tokens']} token choices moved "
            f"({where}), {agree['dropped']} assignments dropped on one "
            f"path only; smallest K-th - (K+1)-th probability margin "
            f"{agree['margin']:.3e}")


def prompt(cfg: ModelConfig, device, n: int = PROMPT) -> torch.Tensor:
    """(1, n + STEPS) tokens below the vocab: a prompt of n and the
    teacher-forced decode tokens."""
    rng = np.random.default_rng(SEED + 3)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, n + STEPS))).to(device)


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max()) / float(b.abs().max())


def unrounded_activations():
    """A measurement, not the model: inside the block the expert
    activations stay in the compute dtype, where the model (as JAX,
    ``layers.py:399-401``) rounds them to bf16 in every compute dtype.
    It tells how much of the f32 path distance that rounding makes."""
    def experts(p, buf, cfg):
        act = layers._act(cfg)
        hexp = act(torch.einsum("becd,edf->becf", buf, p.w_gate)) \
            * torch.einsum("becd,edf->becf", buf, p.w_up)
        return torch.einsum("becf,efd->becd", hexp, p.w_down)

    return patched("experts", experts)


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
    params = init_params(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    toks = prompt(cfg, "cuda")
    for n in args.layers:
        cut, sub = f32_twin(cfg, params, n)
        rk, rp = [], []
        k32 = path_logits(cut, sub, ops, toks, rk)
        p32 = path_logits(cut, sub, plain, toks, rp)
        print(f"{cfg.name} {cut.n_layers} of {cfg.n_layers} layers, f32 "
              f"|kernel - plain| / max |plain| by step: {by_step(k32, p32)}",
              flush=True)
        if cfg.modality != "text":
            front = prompt(cfg, "cuda", FRONTEND_PROMPT)
            k32, p32 = (path_logits(cut, sub, kn, front, frontend=True)
                        for kn in (ops, plain))
            print(f"  {cfg.modality} frontend, {FRONTEND_PROMPT}-token "
                  f"prompt: {by_step(k32, p32)}", flush=True)
        if not rp:
            continue
        print(f"  routes, kernel against plain: "
              f"{route_line(route_agreement(rk, rp, cfg.n_experts))}",
              flush=True)
        forced = path_logits(cut, sub, ops, toks, forced=rp)
        print(f"  kernel path on the plain path's routes: "
              f"{by_step(forced, p32)}", flush=True)
        with unrounded_activations():
            rk, rp = [], []
            k32 = path_logits(cut, sub, ops, toks, rk)
            p32 = path_logits(cut, sub, plain, toks, rp)
        print(f"  expert activations left in f32 (not the model): "
              f"{by_step(k32, p32)}; routes: "
              f"{route_line(route_agreement(rk, rp, cfg.n_experts))}",
              flush=True)


if __name__ == "__main__":
    main()
