"""AdamW, the cosine schedule and global-norm clipping, and the train step
with microbatch accumulation (counterpart of ``repro.training.optimizer``).

The optimizer state mirrors the parameters, keyed by the port's
parameter names: f32 ``m`` and ``v`` beside the f32 master parameters
and their f32 gradients, 16 bytes a parameter as in JAX. On DTensor
parameters (the sharded step) the gradients and moments take the
parameters' placements, as JAX's ``opt_state_specs`` mirror its
parameter specs, and the update runs on each rank's shards. The update is
JAX's formula, ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, which
``torch.optim.AdamW`` (``p * (1 - lr * wd)`` first) does not compute. The
port updates the parameters and moments in place where JAX returns new
trees: at full width a second copy would not fit the card.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..distributed.sharding import TensorSpec, is_dtensor
from ..params import jax_leaves


def opt_state_specs(param_specs: dict[str, TensorSpec]) -> dict:
    """The state :func:`init_opt_state` makes, described without storage
    (``repro.training.optimizer.opt_state_specs``): f32 ``m`` and ``v``
    mirroring each parameter's shape and axes, and JAX's int32 ``step``
    (the port keeps it as a Python int)."""
    def zero(p: TensorSpec) -> TensorSpec:
        return TensorSpec(p.shape, p.axes, torch.float32)
    return {"m": {n: zero(p) for n, p in param_specs.items()},
            "v": {n: zero(p) for n, p in param_specs.items()},
            "step": TensorSpec((), (), torch.int32)}


def init_opt_state(params: dict) -> dict:
    """Zero moments of each parameter (f32) and step 0."""
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "step": 0}


def lr_at(step: int, tcfg: TrainConfig) -> float:
    """Linear warm-up, then a cosine from ``lr`` to ``0.1 lr`` at
    ``total_steps``, in f32 arithmetic as JAX's."""
    f32 = np.float32
    warm = min(f32(step) / f32(max(tcfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((f32(step) - f32(tcfg.warmup_steps))
                   / f32(max(tcfg.total_steps - tcfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * prog))
    return float(f32(tcfg.lr) * warm * (f32(0.1) + f32(0.9) * cos))


def leaf_order(params: dict, cfg) -> list[list[str]]:
    """The parameter names grouped by JAX leaf, in JAX's tree order
    (sorted paths; a stacked leaf's layers in order)."""
    groups = [list(leaf.names) for leaf in jax_leaves(cfg).values()]
    named = {n for g in groups for n in g}
    if named != set(params):
        raise ValueError(f"parameters {sorted(set(params) ^ named)} are "
                         "not the config's")
    return groups


def global_norm(grads: dict, order: list[list[str]]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient in f32, summed leaf by
    leaf in ``order`` (:func:`leaf_order`), as JAX's Python ``sum`` over
    its tree leaves. On DTensors each shard's squares are summed, and the
    partial sums reduced once, at the root: the norm over all shards."""
    total = None
    for group in order:
        part = None
        for n in group:
            sq = torch.sum(torch.square(grads[n].float()))
            part = sq if part is None else part + sq
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt: dict, tcfg: TrainConfig,
                 order: list[list[str]]) -> tuple[dict, dict]:
    """One AdamW step in place on ``params`` and ``opt["m"]``,
    ``opt["v"]``; returns (opt, {"lr", "grad_norm"})."""
    step = opt["step"] + 1
    lr = lr_at(step, tcfg)
    gnorm = global_norm(grads, order)
    scale = torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = opt["m"][name], opt["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
        p.sub_(lr * upd)
    return {**opt, "step": step}, {"lr": lr, "grad_norm": gnorm}


def zero_missing_grads(params: dict) -> None:
    """A parameter the loss does not reach (the token embedding, where a
    frontend's ``embeds`` replace the tokens, in an untied model) gets a
    zero gradient, as ``jax.value_and_grad`` gives it."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def place_grads(params: dict) -> None:
    """A DTensor parameter's gradient at the parameter's placements (a
    partial sum reduced, a replicated one cut), as JAX's gradients take
    their parameters' shardings; a plain tensor's is left as it is."""
    for p in params.values():
        g = p.grad
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)


def loss_and_grads(lm, batch: dict, tcfg: TrainConfig,
                   remat: bool = True) -> tuple[torch.Tensor, dict]:
    """The batch's loss and f32 gradients, by parameter name (the
    parameters must require grad). A batch of B rows is split into
    ``microbatches`` leading slices; each slice's loss is back-propagated
    in turn, the gradients summing in ``.grad`` (the first slice's
    assigned, as JAX adds it to zeros), then both are divided by the
    count. With ``remat`` each layer and CE chunk recomputes its
    activations in the backward."""
    params = dict(lm.named_parameters())
    mb = tcfg.microbatches
    tokens, targets = batch["tokens"], batch["targets"]
    embeds = batch.get("embeds")
    n = tokens.shape[0] // mb
    for p in params.values():
        p.grad = None
    total = None
    for i in range(mb):
        sl = slice(i * n, (i + 1) * n)
        loss = lm.loss(tokens[sl], targets[sl], z_loss=tcfg.z_loss,
                       embeds=None if embeds is None else embeds[sl],
                       remat=remat)
        loss.backward()
        # sharded: the sum kept at the parameters' placements, as JAX's
        # scan carries it, not as a full partial sum a rank
        place_grads(params)
        total = loss.detach() if total is None else total + loss.detach()
    zero_missing_grads(params)
    grads = {name: p.grad for name, p in params.items()}
    if mb > 1:
        total = total / mb
        for g in grads.values():
            g.div_(mb)
    return total, grads


def make_train_step(lm, tcfg: TrainConfig) -> Callable:
    """``(opt, batch) -> (opt, metrics)`` on ``lm``'s parameters, which it
    turns trainable: :func:`loss_and_grads` (remat unless ``tcfg.remat``
    is "none"), then :func:`adamw_update`."""
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    order = leaf_order(params, lm.cfg)
    remat = tcfg.remat != "none"

    def train_step(opt: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads = loss_and_grads(lm, batch, tcfg, remat)
        opt, stats = adamw_update(params, grads, opt, tcfg, order)
        return opt, {"loss": loss, **stats}

    return train_step
