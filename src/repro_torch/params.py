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
from .distributed.sharding import (ShardingCtx, TensorSpec, current_ctx,
                                   on_mesh, placements)
from .models.layers import MATMUL
from .models.rwkv import LORA, rwkv_dims
from .models.ssm import ssm_dims
from .models.transformer import (check_supported, d_ff_head, family_kind,
                                 lg_groups, zamba_groups)


@dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX parameter tree: its shape (stacked leaves carry
    their layer axes first), init and scale, and the port's parameter
    names, one per slice of the ``stacked`` leading axes."""
    shape: tuple
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0
    names: tuple = ()
    stacked: int = 0
    axes: tuple = ()            # JAX's ParamSpec.axes, one a dim

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"{self.names[:1]}: shape {self.shape}, axes "
                             f"{self.axes}")

    @property
    def std(self) -> float:
        """``materialize``'s rule (``distributed/params.py:69``): fan_in is
        the leading axis of a >= 2-D leaf. For a stacked leaf that is the
        first LAYER axis (the layer count; for zamba's ``blocks`` the group
        count), not d_model; kept as the reference has it so the two
        packages draw from the same distributions."""
        shape = self.shape
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        return self.scale / math.sqrt(fan_in)


# A table maps a leaf name to (shape, logical axes, init, scale) as the
# JAX ``*_specs`` give them (``src/repro/models/layers.py:84``, ``:282``,
# ``:305``; ``ssm.py:31``; ``rwkv.py:31``).
NORM = ((None,), "zeros", 1.0)


def _attn(cfg: ModelConfig) -> dict:
    """``attn_specs``."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    out = 1.0 / math.sqrt(2 * cfg.n_layers)
    return {"wq": ((d, H * hd), ("embed_w", "qkv"), "normal", 1.0),
            "wk": ((d, KV * hd), ("embed_w", "kv"), "normal", 1.0),
            "wv": ((d, KV * hd), ("embed_w", "kv"), "normal", 1.0),
            "wo": ((H * hd, d), ("qkv", "embed_w"), "normal", out),
            "norm": ((d,), *NORM)}


def _mlp(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    """``mlp_specs``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": ((d, f), ("embed_w", "mlp"), "normal", 1.0),
            "w_up": ((d, f), ("embed_w", "mlp"), "normal", 1.0),
            "w_down": ((f, d), ("mlp", "embed_w"), "normal",
                       1.0 / math.sqrt(2 * cfg.n_layers)),
            "norm": ((d,), *NORM)}


def _moe(cfg: ModelConfig) -> dict:
    """``moe_specs``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ((d, E), ("embed_w", None), "normal", 1.0),
            "w_gate": ((E, d, f), ("experts", "moe_d", "mlp"), "normal",
                       1.0),
            "w_up": ((E, d, f), ("experts", "moe_d", "mlp"), "normal", 1.0),
            "w_down": ((E, f, d), ("experts", "mlp", "moe_d"), "normal",
                       1.0 / math.sqrt(2 * cfg.n_layers)),
            "norm": ((d,), *NORM)}


def _ssm(cfg: ModelConfig) -> dict:
    """``ssm_specs``."""
    d = cfg.d_model
    d_in, nh, _, ds = ssm_dims(cfg)
    return {"w_xz": ((d, 2 * d_in), ("embed_w", "mlp"), "normal", 1.0),
            "w_B": ((d, ds), ("embed_w", None), "normal", 1.0),
            "w_C": ((d, ds), ("embed_w", None), "normal", 1.0),
            "w_dt": ((d, nh), ("embed_w", None), "normal", 1.0),
            "dt_bias": ((nh,), *NORM),
            "A_log": ((nh,), *NORM),
            "D": ((nh,), (None,), "ones", 1.0),
            "w_out": ((d_in, d), ("mlp", "embed_w"), "normal",
                      1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
            "norm": ((d,), *NORM),
            "out_norm": ((d_in,), *NORM)}


def _rwkv(cfg: ModelConfig) -> dict:
    """``rwkv_specs``."""
    d, f = cfg.d_model, cfg.d_ff
    nh, hd = rwkv_dims(cfg)
    out = 1.0 / math.sqrt(2 * cfg.n_layers)
    leaves = {n: ((d,), *NORM) for n in (
        "tm_norm", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w_bias",
        "o_norm", "cm_norm", "mu_ck")}
    leaves.update({n: ((d, d), ("embed_w", "qkv"), "normal", 1.0)
                   for n in ("w_r", "w_k", "w_v", "w_g")})
    leaves.update({"w_o": ((d, d), ("qkv", "embed_w"), "normal", out),
                   "wd_a": ((d, LORA), ("embed_w", None), "normal", 1.0),
                   "wd_b": ((LORA, d), (None, None), "normal", 1.0),
                   "u": ((nh, hd), (None, None), "zeros", 1.0),
                   "w_ck": ((d, f), ("embed_w", "mlp"), "normal", 1.0),
                   "w_cv": ((f, d), ("mlp", "embed_w"), "normal", out)})
    return leaves


def _stacked(table: dict, path: tuple, lead: tuple, names) -> dict:
    """Leaves of ``table`` under ``path`` with the stacked axes ``lead``
    (replicated, as JAX's ``_stack`` adds them); ``names(leaf)`` gives
    the port names of the slices, in order."""
    return {path + (leaf,): Leaf(lead + shape, init, scale,
                                 tuple(names(leaf)), len(lead),
                                 (None,) * len(lead) + axes)
            for leaf, (shape, axes, init, scale) in table.items()}


def jax_leaves(cfg: ModelConfig) -> dict[tuple, Leaf]:
    """The JAX tree ``model_specs(cfg)`` by path, in the order
    ``materialize`` flattens it (sorted keys), for the families the port
    runs: uniform (dense or MoE ``blocks`` after the ``first_k_dense``
    ``head_layers``), local_global (``blocks.local`` / ``local_mlp``
    stacked (G, R), ``blocks.global`` (G,), ``tail`` (tail,)), zamba and
    rwkv."""
    check_supported(cfg)
    kind = family_kind(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    leaves = {("embed",): Leaf((V, d), names=("embed",),
                               axes=("vocab", "embed_w")),
              ("final_norm",): Leaf((d,), "zeros", names=("final_norm",),
                                    axes=(None,))}
    if not cfg.tie_embeddings:
        leaves[("lm_head",)] = Leaf((d, V), names=("lm_head",),
                                    axes=("embed_w", "vocab"))
    if kind == "uniform":
        k = cfg.first_k_dense
        ffn = ("moe", _moe(cfg)) if cfg.n_experts else ("mlp", _mlp(cfg))
        for sub, table in (("attn", _attn(cfg)), ffn):
            leaves.update(_stacked(
                table, ("blocks", sub), (L - k,),
                lambda leaf, sub=sub: (f"layers.{i}.{sub}.{leaf}"
                                       for i in range(k, L))))
        if k:
            for sub, table in (("attn", _attn(cfg)),
                               ("mlp", _mlp(cfg, d_ff_head(cfg)))):
                leaves.update(_stacked(
                    table, ("head_layers", sub), (k,),
                    lambda leaf, sub=sub: (f"layers.{i}.{sub}.{leaf}"
                                           for i in range(k))))
    elif kind == "local_global":
        R = cfg.local_global_ratio
        G, tail = lg_groups(cfg)
        local = [g * (R + 1) + r for g in range(G) for r in range(R)]
        glob = [g * (R + 1) + R for g in range(G)]
        rest = [G * (R + 1) + t for t in range(tail)]
        for path, lead, at, sub, table in (
                (("blocks", "local"), (G, R), local, "attn", _attn(cfg)),
                (("blocks", "local_mlp"), (G, R), local, "mlp", _mlp(cfg)),
                (("blocks", "global", "attn"), (G,), glob, "attn",
                 _attn(cfg)),
                (("blocks", "global", "mlp"), (G,), glob, "mlp", _mlp(cfg)),
                (("tail", "attn"), (tail,), rest, "attn", _attn(cfg)),
                (("tail", "mlp"), (tail,), rest, "mlp", _mlp(cfg))):
            if at:
                leaves.update(_stacked(
                    table, path, lead,
                    lambda leaf, at=at, sub=sub: (f"layers.{i}.{sub}.{leaf}"
                                                  for i in at)))
    elif kind == "zamba":
        G, tail = zamba_groups(cfg)
        every = cfg.shared_attn_every
        leaves.update(_stacked(_ssm(cfg), ("blocks",), (G, every),
                               lambda leaf: (f"layers.{i}.{leaf}"
                                             for i in range(G * every))))
        if tail:
            leaves.update(_stacked(
                _ssm(cfg), ("tail",), (tail,),
                lambda leaf: (f"layers.{G * every + i}.{leaf}"
                              for i in range(tail))))
        for sub, table in (("shared_attn", _attn(cfg)),
                           ("shared_mlp", _mlp(cfg))):
            leaves.update(_stacked(table, (sub,), (),
                                   lambda leaf, sub=sub: (f"{sub}.{leaf}",)))
    else:
        leaves.update(_stacked(_rwkv(cfg), ("blocks",), (L,),
                               lambda leaf: (f"layers.{i}.{leaf}"
                                             for i in range(L))))
    return dict(sorted(leaves.items()))


def _dtype_of(name: str, dtype: torch.dtype) -> torch.dtype:
    return dtype if name.rsplit(".", 1)[-1] in MATMUL else torch.float32


def param_specs(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
                ) -> dict[str, TensorSpec]:
    """Each parameter of :class:`LM` by name: its shape, its leaf's logical
    axes past the stacked ones, and its dtype (matmul weights in
    ``dtype``, the rest f32; ``dtype`` f32 is the training layout)."""
    return {name: TensorSpec(leaf.shape[leaf.stacked:],
                             leaf.axes[leaf.stacked:], _dtype_of(name, dtype))
            for leaf in jax_leaves(cfg).values() for name in leaf.names}


def count_params(cfg: ModelConfig) -> int:
    """``count_params(model_specs(cfg))`` of the JAX package."""
    return sum(math.prod(leaf.shape) for leaf in jax_leaves(cfg).values())


def param_specs_pspec(cfg: ModelConfig, ctx: Optional[ShardingCtx] = None
                      ) -> dict[str, tuple]:
    """Each parameter's resolved spec under ``ctx`` (the installed
    context by default), by name; a stacked leaf's layers share the spec
    of its dims past the layer axes, which JAX's replicates."""
    return {n: s.spec(ctx) for n, s in param_specs(cfg).items()}


def param_bytes_per_device(cfg: ModelConfig,
                           ctx: Optional[ShardingCtx] = None,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> dict[str, int]:
    """Bytes of each parameter on one device of ``ctx``'s mesh."""
    return {n: s.bytes_per_device(ctx)
            for n, s in param_specs(cfg, dtype).items()}


def from_jax_numpy(tree: dict, cfg: ModelConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   ctx: Optional[ShardingCtx] = None) -> dict:
    """The nested dict ``materialize(model_specs(cfg), key)`` returns,
    with numpy leaves, as the port's parameters: the layer axes of the
    stacked leaves are unstacked into per-layer tensors. Under ``ctx``
    with a device mesh each parameter is a DTensor at its resolved
    placements, cut from the whole tensor on every rank (each rank holds
    the same tree; no collective runs)."""
    dev = resolve_device(device)
    if ctx is not None and ctx.device_mesh is not None:
        from torch.distributed.tensor import distribute_tensor
        specs = param_specs(cfg)
        return {n: distribute_tensor(
                    t, ctx.device_mesh,
                    placements(specs[n].spec(ctx), ctx.device_mesh),
                    src_data_rank=None)
                for n, t in from_jax_numpy(tree, cfg, dev, dtype).items()}
    out = {}
    for path, leaf in jax_leaves(cfg).items():
        node = tree
        for k in path:
            node = node[k]
        arr = np.asarray(node)
        if arr.shape != leaf.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {leaf.shape}")
        parts = arr.reshape((-1,) + leaf.shape[leaf.stacked:])
        for name, part in zip(leaf.names, parts, strict=True):
            t = torch.from_numpy(np.array(part, dtype=np.float32))
            out[name] = t.to(device=dev, dtype=_dtype_of(name, dtype))
    return out


def shard_params(lm, ctx: Optional[ShardingCtx] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
    """Turns each parameter of ``lm`` (an :class:`LM` on the meta device)
    into a DTensor at
    its ``param_specs_pspec`` placements on ``ctx``'s device mesh (the
    installed context by default), in place; returns ``lm``. A meta
    parameter becomes this rank's shard made directly: on the meta
    device, or with ``device`` (the card) drawn there as
    :func:`init_params` draws it (a generator seeded with the rank). The
    whole tensor is never made: deepseek-67b's f32 masters whole are
    269.7 GB. On the card every shard is allocated, in its dtype, before
    the first f32 draw is made and cast into its shard: the shards are
    the process's first allocations, each in a segment of its own, as the
    dry run counts them (``fresh_process_bytes``), never cut from a
    draw's freed block; the values are the same. Parameters with values
    take :func:`from_jax_numpy`'s sharded form."""
    ctx = ctx or current_ctx()
    if ctx is None or ctx.device_mesh is None:
        raise ValueError("shard_params needs a context with a device mesh")
    mesh = ctx.device_mesh
    specs = param_specs(lm.cfg)
    init = {n: leaf for leaf in jax_leaves(lm.cfg).values()
            for n in leaf.names}
    gen = None
    if device is not None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(mesh.get_rank())
    shards = {}
    for name, p in lm.named_parameters():
        if not p.is_meta:
            raise ValueError(f"shard_params: {name} is not on the meta "
                             "device (from_jax_numpy(..., ctx=) places "
                             "parameters with values)")
        spec = TensorSpec(tuple(p.shape), specs[name].axes, p.dtype)
        shape = spec.local_shape(ctx)
        if gen is not None and init[name].init in ("zeros", "ones"):
            fill = torch.zeros if init[name].init == "zeros" else torch.ones
            local = fill(shape, dtype=p.dtype, device=dev)
        else:
            local = torch.empty(shape, dtype=p.dtype,
                                device=p.device if gen is None else dev)
        shards[name] = (spec, local)
    for name, p in list(lm.named_parameters()):
        spec, local = shards.pop(name)
        if gen is not None and init[name].init not in ("zeros", "ones"):
            local.copy_(torch.randn(local.shape, generator=gen, device=dev)
                        * init[name].std)
        t = on_mesh(local, p.shape, spec.spec(ctx), ctx)
        owner, _, leaf = name.rpartition(".")
        module = lm.get_submodule(owner) if owner else lm
        module._parameters[leaf] = torch.nn.Parameter(
            t, requires_grad=p.requires_grad)
    return lm


def to_jax_numpy(lm_or_params, cfg: ModelConfig) -> dict:
    """The inverse of :func:`from_jax_numpy`: an :class:`LM`'s parameters,
    or any dict of tensors under its parameter names (AdamW's moments),
    as JAX's nested tree of f32 numpy leaves, the per-layer tensors
    stacked back into the (L, ...) leaves under JAX's paths. A checkpoint
    of it is laid out as one of JAX's."""
    params = (dict(lm_or_params.named_parameters())
              if isinstance(lm_or_params, torch.nn.Module) else lm_or_params)
    tree: dict = {}
    for path, leaf in jax_leaves(cfg).items():
        out = torch.empty((len(leaf.names),) + leaf.shape[leaf.stacked:],
                          dtype=torch.float32)
        for i, n in enumerate(leaf.names):       # one copy off the device
            out[i].copy_(params[n].detach())
        arr = out.numpy().reshape(leaf.shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random parameters drawn on ``device`` from the same distributions
    as ``materialize`` (normal with :attr:`Leaf.std`, zeros or ones),
    from an explicit generator seeded with ``seed``. Drawn leaf by leaf
    and layer by layer, so the host never holds the model and the card
    holds at most one f32 layer matrix beyond the result."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for path, leaf in jax_leaves(cfg).items():
        shape = leaf.shape[leaf.stacked:]
        for name in leaf.names:
            dt = _dtype_of(name, dtype)
            if leaf.init in ("zeros", "ones"):
                fill = torch.zeros if leaf.init == "zeros" else torch.ones
                out[name] = fill(shape, dtype=dt, device=dev)
            else:
                t = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=dev)
                out[name] = (t * leaf.std).to(dt)
    return out
