"""The train state as JAX's checkpoint tree: ``{"params": ..., "opt":
{"m": ..., "v": ..., "step": int32}, "data": {"seed", "step"}}`` with the
parameter and moment leaves stacked under JAX's paths
(``params.to_jax_numpy``), so that ``CheckpointManager`` writes the
layout JAX's launcher writes and either package resumes from the other's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import jax_leaves, to_jax_numpy


def _tree(cfg, leaf_fn) -> dict:
    tree: dict = {}
    for path, leaf in jax_leaves(cfg).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf_fn(leaf)
    return tree


def train_state(lm, opt: dict, data_state: dict) -> dict:
    """The state to save: parameters, moments and step, data position."""
    cfg = lm.cfg
    return {"params": to_jax_numpy(lm, cfg),
            "opt": {"m": to_jax_numpy(opt["m"], cfg),
                    "v": to_jax_numpy(opt["v"], cfg),
                    "step": np.asarray(opt["step"], dtype=np.int32)},
            "data": {k: np.asarray(int(v)) for k, v in data_state.items()}}


def state_like(cfg) -> dict:
    """A tree of the state's structure, dtypes and shapes for
    ``CheckpointManager.restore`` (``np.empty``: nothing is filled)."""
    def leaf(x):
        return np.empty(x.shape, np.float32)
    return {"params": _tree(cfg, leaf),
            "opt": {"m": _tree(cfg, leaf), "v": _tree(cfg, leaf),
                    "step": np.asarray(0, dtype=np.int32)},
            "data": {"seed": np.asarray(0), "step": np.asarray(0)}}


def _load(dst: dict, tree: dict, cfg) -> None:
    for path, leaf in jax_leaves(cfg).items():
        node = tree
        for k in path:
            node = node[k]
        parts = np.asarray(node).reshape((-1,) + leaf.shape[leaf.stacked:])
        for name, part in zip(leaf.names, parts, strict=True):
            dst[name].copy_(torch.from_numpy(np.ascontiguousarray(part)))


@torch.no_grad()
def load_train_state(tree: dict, lm, opt: dict) -> tuple[dict, dict]:
    """Copies a restored state into ``lm``'s parameters and the moments of
    ``opt`` in place; returns (opt with its step, the data state)."""
    _load(dict(lm.named_parameters()), tree["params"], lm.cfg)
    _load(opt["m"], tree["opt"]["m"], lm.cfg)
    _load(opt["v"], tree["opt"]["v"], lm.cfg)
    data = {k: int(v) for k, v in tree["data"].items()}
    return {**opt, "step": int(tree["opt"]["step"])}, data
