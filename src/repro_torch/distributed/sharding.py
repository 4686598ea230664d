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
it compares entry for entry with JAX's. The dry run reckons each
tensor's bytes on one device of a mesh from its spec.

The sharded step runs on DTensors: a context with a
``torch.distributed`` ``DeviceMesh`` over the mesh (``use_mesh(...,
device_mesh=)``, dims named as the mesh's axes) places a tensor by
:func:`placements` of its spec (:func:`named_sharding`), and
:func:`shard`, JAX's sharding constraint, redistributes a DTensor to its
logical axes' placements. Without a device mesh, and on a plain tensor,
both leave everything as it is: the single-device path never changes.
:func:`on_local` runs a function on each rank's shards with its
outputs' placements stated (the MoE layer's dispatch, expert products
and combine). Every arch runs the sharded step: the ``uniform`` stacks,
dense and MoE, with text or a frontend's embeddings, gemma3's
``local_global`` rings, and zamba2's and rwkv6's scans on their heads.
Where the KV heads do not divide the model axis (qwen2-vl's 2 over 4)
the resolver puts the cache's sequence there (``kv_seq``); the model
gathers k and v and its decode merges the ranks' partial softmax states
(``kernels.ops``), as XLA's collectives do for JAX.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

# The installed context, one a process (JAX keeps one a thread): autograd
# runs a CUDA backward, and with it the layers' recomputation under
# checkpoint, on a worker thread of its own, whose ``shard`` calls must
# see the step's context.
_STATE = SimpleNamespace(ctx=None)

# DTensor's class, looked up once (every kernel call asks is_dtensor); a
# build without torch.distributed has none, and ``isinstance(x, ())`` is
# False
if torch.distributed.is_available():
    from torch.distributed.tensor import DTensor as _DTENSOR
else:
    _DTENSOR = ()

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
    """The mesh, the rules, and the ``DeviceMesh`` the sharded step's
    DTensors live on (None: the specs are only reckoned)."""
    mesh: Mesh
    rules: dict[str, list[Optional[tuple[str, ...]]]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))
    device_mesh: Optional[object] = None

    def axis_size(self, name: str) -> int:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))[name]


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextmanager
def use_mesh(mesh: Mesh, rules: Optional[dict] = None, device_mesh=None):
    """Installs a context of ``mesh`` (and, for the sharded step, the
    ``DeviceMesh`` over it: ``launch.mesh.device_mesh``). With a device
    mesh a plain tensor that meets a DTensor in the block (positions, a
    row index, rotary angles: the same on every rank) counts as
    replicated: run the step's backward inside the block too."""
    if device_mesh is not None and (
            tuple(device_mesh.mesh_dim_names or ()) != tuple(mesh.axis_names)
            or tuple(device_mesh.shape) != mesh.devices.shape):
        raise ValueError(f"device mesh {device_mesh} is not laid out as "
                         f"{mesh.shape}")
    prev = getattr(_STATE, "ctx", None)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _STATE.ctx = ShardingCtx(mesh=mesh, rules=merged,
                             device_mesh=device_mesh)
    try:
        if device_mesh is None:
            yield _STATE.ctx
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
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


def _entry_axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def spec_shards(spec: tuple, ctx: Optional[ShardingCtx]) -> int:
    """The devices a tensor of ``spec`` is split over (1: replicated)."""
    n = 1
    for entry in spec:
        for a in _entry_axes(entry):
            n *= ctx.axis_size(a)
    return n


def placements(spec: tuple, device_mesh) -> tuple:
    """The DTensor placements of a resolved spec on ``device_mesh`` (its
    dims named as the mesh axes): ``Shard(i)`` on each mesh dim that
    tensor dim i carries, ``Replicate()`` on the others. A dim that
    carries several axes takes them in the mesh's order, major first, as
    JAX's ``NamedSharding`` lays them out. A mesh dim of one device
    replicates: the same layout, which DTensor then never redistributes
    (``quad``'s data axis)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        at = [names.index(a) for a in _entry_axes(entry)]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: dim {i} takes mesh axes out of "
                             f"the mesh's order {names}")
        for m in at:
            if device_mesh.size(m) > 1:
                out[m] = Shard(i)
    return tuple(out)


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                   ctx: Optional[ShardingCtx] = None):
    """``(device_mesh, placements)`` of a tensor of ``shape`` with logical
    ``axes`` under ``ctx`` (the installed context by default); None
    outside a context with a device mesh."""
    ctx = ctx or current_ctx()
    if ctx is None or ctx.device_mesh is None:
        return None
    return ctx.device_mesh, placements(resolve_spec(shape, axes, ctx),
                                       ctx.device_mesh)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False without ``torch.distributed``)."""
    return isinstance(x, _DTENSOR)


def shard(x, *axes: Optional[str]):
    """JAX's sharding constraint: a DTensor ``x`` redistributed to the
    placements of its logical ``axes`` under the installed context. The
    identity outside a context with a device mesh and on a plain tensor,
    as JAX's is outside a mesh."""
    ctx = current_ctx()
    if ctx is None or ctx.device_mesh is None or not is_dtensor(x):
        return x
    return place(x, named_sharding(x.shape, axes, ctx)[1])


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

    def local_shape(self, ctx: Optional[ShardingCtx] = None) -> tuple:
        """The shape of one device's shard under ``ctx`` (the resolver
        picks only mesh axes that divide their dim)."""
        ctx = ctx or current_ctx()
        if ctx is None:
            return tuple(self.shape)
        spec = self.spec(ctx)
        return tuple(n // (spec_shards((spec[i],), ctx) if i < len(spec)
                           else 1) for i, n in enumerate(self.shape))

    def zeros(self, device, ctx: Optional[ShardingCtx] = None
              ) -> torch.Tensor:
        """A zeroed tensor of this spec on ``device``; under a context
        with a device mesh a DTensor of its placements, each rank's shard
        made in place (never the whole tensor)."""
        ctx = ctx or current_ctx()
        if ctx is None or ctx.device_mesh is None:
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        local = torch.zeros(self.local_shape(ctx), dtype=self.dtype,
                            device=device)
        return on_mesh(local, self.shape, self.spec(ctx), ctx)

    def bytes_per_device(self, ctx: Optional[ShardingCtx] = None) -> int:
        """Bytes one device holds under ``ctx`` (the whole tensor without
        one); the resolver picks only mesh axes that divide their dim."""
        ctx = ctx or current_ctx()
        if ctx is None:
            return self.nbytes
        return self.nbytes // spec_shards(self.spec(ctx), ctx)


def place(x, placements: Sequence) -> torch.Tensor:
    """The DTensor ``x`` redistributed to ``placements`` on its device
    mesh (``x`` itself where it is there already)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, tuple(placements))


def on_mesh(local: torch.Tensor, shape: Sequence[int], spec: tuple,
            ctx: ShardingCtx):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (contiguous), placed by ``spec`` on ``ctx``'s device mesh;
    no collective runs."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ctx.device_mesh,
                              placements(spec, ctx.device_mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def on_local(fn, args: Sequence, outs: Sequence[tuple]):
    """``fn`` on this rank's shards of the DTensors ``args`` (one device
    mesh), its outputs the DTensors that ``outs`` describes, one ``(global
    shape, placements)`` an output, each local output its shard there (a
    ``Partial`` placement: its part of a sum); no collective runs, and
    the outputs are contiguous, their global stride stated (torch's
    ``local_map`` infers it from the shard, which a later view of a
    tensor split on two dims refuses). Where an argument is replicated on a
    mesh dim that splits or partially sums an output, its gradient there
    is a partial sum (each rank's part comes from its shard of the work),
    reduced where it is used; elsewhere it takes the argument's
    placements. Returns a tuple of DTensors."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor, Partial
    mesh = args[0].device_mesh
    split = [any(not pl[m].is_replicate() for _, pl in outs)
             for m in range(mesh.ndim)]
    local = []
    for a in args:
        if not (is_dtensor(a) and a.device_mesh == mesh):
            raise ValueError(f"on_local: an argument is not a DTensor on "
                             f"{mesh}")
        grad = tuple(Partial() if p.is_replicate() and split[m] else p
                     for m, p in enumerate(a.placements))
        t = a.to_local(grad_placements=grad)
        local.append(t.wait() if isinstance(t, AsyncCollectiveTensor) else t)
    got = fn(*local)
    got = got if isinstance(got, tuple) else (got,)
    return tuple(DTensor.from_local(t.contiguous(), mesh, tuple(pl),
                                    run_check=False, shape=torch.Size(shape),
                                    stride=contiguous_stride(shape))
                 for t, (shape, pl) in zip(got, outs, strict=True))


def contiguous_stride(shape: Sequence[int]) -> tuple:
    """The row-major strides of ``shape``."""
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= s
    return tuple(reversed(out))
