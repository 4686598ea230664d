"""Logical-axis sharding resolver (own copy of
``repro.distributed.sharding``, as pure logic).

Tensors are described by LOGICAL axis names ("batch", "heads", "mlp",
...). The resolver maps each name to mesh axes through priority-ordered
candidate chains, skipping a candidate that does not divide the
dimension or whose mesh axes an earlier dimension of the same tensor has
taken; JAX's rules, priorities and fallbacks unchanged
(``src/repro/distributed/sharding.py:38-157``).

A mesh here is a numpy array of ``torch.device`` objects with axis
names; no process group is needed to resolve a spec. A spec is a tuple
in JAX's ``PartitionSpec`` layout: one entry a dimension, ``None``, a
mesh-axis name or a tuple of names, trailing ``None``s dropped, so that
it compares entry for entry with JAX's. The port has no sharded step, so
JAX's ``shard`` (a sharding constraint inside a jitted step) and
``named_sharding`` have no counterpart: the dry run uses the specs to
reckon each tensor's bytes on one device of a mesh.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

_STATE = threading.local()

# Candidate chains: logical axis -> mesh-axis tuples to try in order; None
# replicates. Axes a mesh lacks (a single-host mesh has no "pod") are
# dropped from a candidate.
DEFAULT_RULES: dict[str, list[Optional[tuple[str, ...]]]] = {
    "batch":    [("pod", "data"), ("data",)],
    "seq":      [None],
    "embed":    [None],
    "embed_w":  [("pod", "data"), ("data",)],   # FSDP / ZeRO-3 dim
    "heads":    [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [None],
    "kv":       [("model",)],                    # flattened kv*head_dim
    "qkv":      [("model",)],                    # flattened heads*head_dim
    "mlp":      [("model",)],
    "experts":  [("model",)],
    "moe_cap":  [None],
    "moe_d":    [("model",), ("data",)],
    "vocab":    [("model",)],
    "kv_seq":   [("model",)],                    # cache seq (fallback TP)
    "ce_seq":   [("model",)],
    "attn_batch": [("pod", "data", "model"), ("data", "model"),
                   ("pod", "data"), ("data",)],
    "ssm":      [None],
    "conv":     [None],
}

# Dims with lower priority numbers claim mesh axes first.
RESOLVE_PRIORITY = {
    "heads": 0, "kv_heads": 0, "experts": 0, "vocab": 0,
    "moe_d": 0.5,
    "qkv": 1, "kv": 1, "mlp": 1, "moe_cap": 1, "kv_seq": 1, "ce_seq": 1,
    "embed_w": 2,
    "batch": 4, "attn_batch": 4,
}


@dataclass(frozen=True)
class Mesh:
    """Devices (an ndarray of ``torch.device``) laid out over named axes."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


@dataclass
class ShardingCtx:
    mesh: Mesh
    rules: dict[str, list[Optional[tuple[str, ...]]]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def axis_size(self, name: str) -> int:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))[name]


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextmanager
def use_mesh(mesh: Mesh, rules: Optional[dict] = None):
    prev = getattr(_STATE, "ctx", None)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _STATE.ctx = ShardingCtx(mesh=mesh, rules=merged)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 ctx: Optional[ShardingCtx] = None) -> tuple:
    """Resolve logical axes to a spec with fallback and used-axis
    tracking; ``axes`` entries may be None (a replicated dim). Without a
    context (none given, none installed) the spec is ``()``."""
    ctx = ctx or current_ctx()
    if ctx is None:
        return ()
    axes, shape = list(axes), list(shape)
    mesh_axes = set(ctx.mesh.axis_names)
    used: set[str] = set()
    out: list = [None] * len(axes)
    order = sorted(range(len(out)),
                   key=lambda i: (RESOLVE_PRIORITY.get(axes[i], 3), i))
    for i in order:
        name = axes[i]
        if name is None:
            continue
        chosen = None
        for cand in ctx.rules.get(name, [None]):
            if cand is None:
                break
            cand_t = tuple(a for a in cand if a in mesh_axes)
            if not cand_t or any(a in used for a in cand_t):
                continue
            size = int(np.prod([ctx.axis_size(a) for a in cand_t]))
            if dim_divides(shape[i], size):
                chosen = cand_t
                used.update(cand_t)
                break
        out[i] = chosen if chosen is None or len(chosen) > 1 else chosen[0]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def dim_divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def spec_shards(spec: tuple, ctx: Optional[ShardingCtx]) -> int:
    """The devices a tensor of ``spec`` is split over (1: replicated)."""
    n = 1
    for entry in spec:
        for a in (() if entry is None else
                  entry if isinstance(entry, tuple) else (entry,)):
            n *= ctx.axis_size(a)
    return n


@dataclass(frozen=True)
class TensorSpec:
    """A tensor described without storage: its shape, logical axes (one
    a dim) and dtype; the counterpart of JAX's ``ParamSpec`` for what the
    dry run reckons (parameters, optimizer state, caches, batches)."""
    shape: tuple
    axes: tuple
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes}")

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize

    def spec(self, ctx: Optional[ShardingCtx] = None) -> tuple:
        return resolve_spec(self.shape, self.axes, ctx)

    def bytes_per_device(self, ctx: Optional[ShardingCtx] = None) -> int:
        """Bytes one device holds under ``ctx`` (the whole tensor without
        one); the resolver picks only mesh axes that divide their dim."""
        ctx = ctx or current_ctx()
        if ctx is None:
            return self.nbytes
        return self.nbytes // spec_shards(self.spec(ctx), ctx)
