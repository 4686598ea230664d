"""Parameters of the port: the weight bridge from the JAX package and an
on-device initialiser (counterpart of ``repro.distributed.params``).

A parameter set is a flat dict of tensors named as :class:`LM`'s
parameters. Matmul weights are in the compute dtype, cast once here;
JAX keeps them f32 and casts on every use (``layers.py:34``), which
gives the same values. Norm weights, ``embed`` and ``lm_head`` stay f32,
as the JAX code reads them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models.transformer import check_supported

MATMUL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX parameter tree: its shape (per-layer leaves
    carry the stacked layer axis first), init and scale."""
    shape: tuple
    init: str = "normal"        # normal | zeros
    scale: float = 1.0

    @property
    def std(self) -> float:
        """``materialize``'s rule (``distributed/params.py:69``): fan_in is
        the leading axis of a >= 2-D leaf. For a stacked per-layer leaf
        that is the LAYER COUNT, not d_model; kept as the reference has
        it so the two packages draw from the same distributions."""
        shape = self.shape
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        return self.scale / math.sqrt(fan_in)


def jax_leaves(cfg: ModelConfig) -> dict[tuple, Leaf]:
    """The JAX tree ``model_specs(cfg)`` of a dense uniform stack, by path,
    in the order ``materialize`` flattens it (sorted keys)."""
    check_supported(cfg)
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out_scale = 1.0 / math.sqrt(2 * L)
    leaves = {
        ("blocks", "attn", "norm"): Leaf((L, d), "zeros"),
        ("blocks", "attn", "wk"): Leaf((L, d, KV * hd)),
        ("blocks", "attn", "wo"): Leaf((L, H * hd, d), scale=out_scale),
        ("blocks", "attn", "wq"): Leaf((L, d, H * hd)),
        ("blocks", "attn", "wv"): Leaf((L, d, KV * hd)),
        ("blocks", "mlp", "norm"): Leaf((L, d), "zeros"),
        ("blocks", "mlp", "w_down"): Leaf((L, f, d), scale=out_scale),
        ("blocks", "mlp", "w_gate"): Leaf((L, d, f)),
        ("blocks", "mlp", "w_up"): Leaf((L, d, f)),
        ("embed",): Leaf((V, d)),
        ("final_norm",): Leaf((d,), "zeros"),
    }
    if not cfg.tie_embeddings:
        leaves[("lm_head",)] = Leaf((d, V))
    return dict(sorted(leaves.items()))


def _names(path: tuple, n_layers: int) -> list[str]:
    """Port parameter names of a JAX leaf: one per layer for ``blocks``."""
    if path[0] == "blocks":
        return [f"layers.{i}.{path[1]}.{path[2]}" for i in range(n_layers)]
    return [path[0]]


def _dtype_of(name: str, dtype: torch.dtype) -> torch.dtype:
    return dtype if name.rsplit(".", 1)[-1] in MATMUL else torch.float32


def from_jax_numpy(tree: dict, cfg: ModelConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The nested dict ``materialize(model_specs(cfg), key)`` returns,
    with numpy leaves, as the port's parameters: the layer axis of the
    ``blocks`` leaves is unstacked into per-layer tensors."""
    dev = resolve_device(device)
    out = {}
    for path, leaf in jax_leaves(cfg).items():
        node = tree
        for k in path:
            node = node[k]
        arr = np.asarray(node)
        if arr.shape != leaf.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {leaf.shape}")
        names = _names(path, cfg.n_layers)
        parts = list(arr) if path[0] == "blocks" else [arr]
        for name, part in zip(names, parts):
            t = torch.from_numpy(np.array(part, dtype=np.float32))
            out[name] = t.to(device=dev, dtype=_dtype_of(name, dtype))
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random parameters drawn on ``device`` from the same distributions
    as ``materialize`` (normal with :attr:`Leaf.std`, zeros for norms),
    from an explicit generator seeded with ``seed``. Drawn leaf by leaf
    and layer by layer, so the host never holds the model and the card
    holds at most one f32 layer matrix beyond the result."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for path, leaf in jax_leaves(cfg).items():
        names = _names(path, cfg.n_layers)
        shape = leaf.shape[1:] if path[0] == "blocks" else leaf.shape
        for name in names:
            dt = _dtype_of(name, dtype)
            if leaf.init == "zeros":
                out[name] = torch.zeros(shape, dtype=dt, device=dev)
            else:
                t = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=dev)
                out[name] = (t * leaf.std).to(dt)
    return out
