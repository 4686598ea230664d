"""Dry run on the meta device: reckon every (arch x shape x mesh) cell's
memory and roofline terms against the H100, with no card and no
allocation (counterpart of ``repro.launch.dryrun``).

For each cell it builds :class:`LM` on ``device="meta"`` and runs the
shape's step on meta tensors: a train step (``LM.loss`` of one
microbatch, its backward with per-layer remat, then the AdamW update), a
prefill, or a decode step over ``new_cache``. The hand-written kernels'
wrappers take their meta route (``kernels/ops.py``): each allocates and
saves what its CUDA call does, skips the launch and records its bytes
and flops (``kernels/costs.py``). :class:`MetaTracker` follows every
storage's life as the caching allocator would hold it (each rounded up
to 512 bytes), counts each aten op's input and output bytes (XLA's
"bytes accessed") and its flops by ``torch.utils.flop_counter``'s
formulas, and refuses a CUDA tensor.

The JSON keys are JAX's wherever a counterpart exists; XLA's own cost
analysis (``xla_flops``, ``xla_bytes``) and ``compile_s`` have none and
are null, and ``lower_s`` is the meta run's seconds. ``mem_temp_bytes``
is XLA's identity ``peak - args - (outputs - aliased outputs)``.
Added: ``peak_bytes``, ``fresh_process_bytes``, what the same step
holds beyond that peak in a fresh process (:func:`fresh_process_bytes`:
cuBLAS's workspaces and the arguments' segment remainders), and ``fits``
(the two together within ``mesh.HBM_USABLE``, what one H100 80GB HBM3
lets a step allocate: 80.0 GB).

A train cell runs ONE microbatch on meta: where there are several, the
gradient accumulator (f32, a parameter's size each) is live from its
start, as on the card's later microbatches, and the step's peak is that
microbatch's peak or the update's; its flops and bytes are the
microbatch's times the count, plus the update's.

On a mesh of more than one device every arch runs the sharded step (the
``uniform`` stacks, dense and MoE, with text or a frontend's embeddings,
qwen2-vl's cache split on its sequence among them, gemma3's
``local_global`` rings, zamba2's and rwkv6's scans on their heads): rank
0 of the mesh
under ``mesh.fake_group`` on a ``cpu`` device mesh, its parameters,
optimizer state, cache and batch meta DTensors at their resolved specs
(``params.shard_params``, ``TensorSpec.zeros``). The tracker sees each
rank's local ops (:class:`CollectiveCounter`), so the memory, flops and
bytes are one device's, and it counts the collectives by kind with their
operand bytes (XLA's ``collective_bytes``); ``t_collective`` is those
bytes over ``mesh.NVLINK_BW``.

  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k \\
      --layers 12 --batch 4 --microbatches 2
  python -m repro_torch.launch.dryrun --all --mesh both   # results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCHS, SHAPES, ModelConfig, TrainConfig, get_config,
                       shape_applicable)
from ..distributed.sharding import (ShardingCtx, TensorSpec, current_ctx,
                                   is_dtensor, use_mesh)
from ..kernels import costs
from ..models.rwkv import LORA
from ..models.ssm import ssm_dims
from ..models.transformer import (LM, cache_specs, family_kind, lg_layers,
                                  zamba_groups)
from ..params import count_params, param_specs, shard_params
from ..training.optimizer import (adamw_update, init_opt_state, leaf_order,
                                  opt_state_specs, place_grads,
                                  zero_missing_grads)
from .mesh import (CUBLAS_WORKSPACE, HBM_BW, HBM_USABLE, MESHES, NVLINK_BW,
                   PEAK_FLOPS_BF16, PEAK_FLOPS_F32, Mesh, device_mesh,
                   fake_group, mesh_preset)

ALLOC_ROUND = 512       # the caching allocator's block granularity
META = torch.device("meta")
OUT_DIR = "results/dryrun_torch"
#: the functional collectives (DTensor's) by XLA's kind names
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_FUNCOL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")


def alloc_bytes(nbytes: int) -> int:
    """What the caching allocator holds for an allocation of ``nbytes``."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def segment_bytes(nbytes: int) -> int:
    """What the caching allocator holds for ``nbytes`` served from a
    segment made for it (no cached block to split, as in a fresh
    process): from 10 MiB up the segment is the request rounded up to 2
    MiB, and a remainder of 1 MiB or less is not split off but stays
    with the block; elsewhere :func:`alloc_bytes`."""
    n = alloc_bytes(nbytes)
    if n < 10 * 2**20:
        return n
    seg = -(-n // 2**21) * 2**21
    return seg if seg - n <= 2**20 else n


def fresh_process_bytes(specs: dict, ctx: Optional[ShardingCtx],
                        kind: str) -> int:
    """What a step in a fresh process holds at its peak beyond the dry
    run's count: each argument's segment remainder (:func:`segment_bytes`,
    the arguments being the process's first allocations), and a cuBLAS
    workspace for each thread that runs matmuls (the forward's; a train
    step's backward runs on autograd's device thread). A step's own
    tensors reuse cached blocks, or make segments, as the allocator's
    history has it: not counted."""
    remainders = sum(segment_bytes(s.bytes_per_device(ctx))
                     - alloc_bytes(s.bytes_per_device(ctx))
                     for group in specs.values() for s in group.values())
    return remainders + (2 if kind == "train" else 1) * CUBLAS_WORKSPACE


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


class CollectiveCounter(TorchDispatchMode):
    """Sees one rank's local ops: an op on DTensors is handed back
    (``NotImplemented``), so DTensor runs it on the local shards, whose
    ops, and the collectives a redistribution issues, come here; the
    fake-tensor ops of DTensor's shape propagation are passed by.
    ``collectives`` counts each kind (:data:`COLLECTIVES`) and its
    operand bytes, and ``log`` each one's kind and operand shape in
    order; a collective over a group of one rank moves nothing and is
    not counted. Runs on the card as on the meta device."""

    def __init__(self):
        super().__init__()
        self.collectives: dict[str, dict] = {}
        self.log: list[tuple[str, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat = tree_flatten((args, kwargs, out))[0]
        if not any(isinstance(t, FakeTensor) for t in flat):
            self.local_op(func, args, kwargs, out)
        return out

    def local_op(self, func, args, kwargs, out) -> None:
        kind = COLLECTIVES.get(func._overloadpacket.__name__)
        # a functional collective's last argument names its group
        if func.namespace in _FUNCOL and kind and _group_size(args[-1]) > 1:
            c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += args[0].numel() * args[0].element_size()
            self.log.append((kind, tuple(args[0].shape)))


class MetaTracker(CollectiveCounter):
    """Inside the block: every meta storage an op makes is live until its
    last tensor dies (a weak reference to the storage, which PyTorch keeps
    as long as any tensor, view or saved tensor holds it), at
    :func:`alloc_bytes` of its size; ``peak`` is the most live at once.
    ``op_bytes`` sums each aten op's input and output bytes (views and
    collectives move none), ``flops`` each op's flops by the peak rate of
    its inputs' dtype. On DTensors all of it is one rank's: its local
    shards (:class:`CollectiveCounter`). A CUDA tensor raises: the dry run
    allocates nothing on a device."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.op_bytes = 0
        self.flops: dict[float, float] = defaultdict(float)
        self.calls: list = []        # the kernels' recorded meta calls
        self._held: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def track(self, *trees) -> int:
        """Holds the storages of the tensors in ``trees`` (arguments made
        before the block) as live; returns their bytes."""
        before = self.live
        for t in tree_flatten(trees)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return self.live - before

    def _hold(self, t: torch.Tensor) -> None:
        if is_dtensor(t):
            t = t._local_tensor
        if t.device.type == "cuda":
            raise RuntimeError("the dry run met a CUDA tensor: it allocates "
                               "nothing on a device")
        if not t.is_meta:
            return
        s = t.untyped_storage()
        key = id(s)
        if key in self._held:
            return
        n = alloc_bytes(s.nbytes())
        self._held[key] = n
        weakref.finalize(s, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def local_op(self, func, args, kwargs, out) -> None:
        super().local_op(func, args, kwargs, out)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in ins:
            if t.device.type == "cuda":
                raise RuntimeError(f"the dry run met a CUDA tensor in {func}")
        for t in outs:
            self._hold(t)
        if not func.is_view and func.namespace not in _FUNCOL:
            self.op_bytes += sum(t.numel() * t.element_size()
                                 for t in {id(t): t for t in ins + outs}
                                 .values())
        packet = func._overloadpacket
        if packet in flop_registry:
            dt = next((t.dtype for t in ins if t.is_floating_point()), None)
            rate = (PEAK_FLOPS_BF16 if dt == torch.bfloat16
                    else PEAK_FLOPS_F32)
            self.flops[rate] += flop_registry[packet](*args, **kwargs,
                                                      out_val=out)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if is_dtensor(t) else t


def _nbytes(tree) -> int:
    return sum(alloc_bytes(_local(t).untyped_storage().nbytes())
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def trace(fn: Callable, args: tuple) -> dict:
    """Runs ``fn(tracker, *args)`` on meta tensors under a
    :class:`MetaTracker` and the kernels' cost recording. Returns
    ``peak`` (bytes), ``arg`` (the arguments' bytes, tracked before the
    run), ``op_bytes``, ``flops`` (rate -> aten flops), ``kernels`` (the
    recorded ``(name, bytes, flops, rate)`` calls), ``collectives`` and
    ``collective_log`` (:class:`CollectiveCounter`'s) and ``out`` (fn's
    result)."""
    tracker = MetaTracker()
    with costs.recording() as tracker.calls, tracker:
        arg = tracker.track(args)
        out = fn(tracker, *args)
    return {"peak": tracker.peak, "arg": arg, "op_bytes": tracker.op_bytes,
            "flops": dict(tracker.flops), "kernels": tracker.calls,
            "collectives": tracker.collectives,
            "collective_log": tracker.log, "out": out}


def peak_of(fn: Callable[[], object], inputs) -> int:
    """The bytes a call of ``fn`` on the meta tensors ``inputs`` holds at
    its peak beyond them (its outputs and saved tensors included): the
    count that ``torch.cuda.max_memory_allocated`` gives the same call on
    the card."""
    def run(tracker, *_):
        tracker.out = fn()           # kept alive until the count is read
    res = trace(run, (inputs,))
    return res["peak"] - res["arg"]


# -- the steps -------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, batch: int, seq: int, kind: str
                ) -> dict[str, TensorSpec]:
    """The step's inputs, as JAX's dry run feeds them: the train batch
    (tokens and targets, int32 as ``SyntheticLM`` makes them), the
    prefill prompt or decode's token and position (int64, the engine's),
    and for a vision or audio arch the frontend's embeddings (B, S, d)
    bf16 in place of the prompt's."""
    if kind == "decode":
        one = TensorSpec((batch,), ("batch",), torch.int64)
        return {"token": one, "pos": one}
    ids = TensorSpec((batch, seq), ("batch", "seq"),
                     torch.int32 if kind == "train" else torch.int64)
    out = {"tokens": ids, **({"targets": ids} if kind == "train" else {})}
    if cfg.modality != "text":
        out["embeds"] = TensorSpec((batch, seq, cfg.d_model),
                                   ("batch", "seq", None), torch.bfloat16)
    return out


def on_meta(specs: dict[str, TensorSpec]) -> dict[str, torch.Tensor]:
    """The tensors of ``specs`` on the meta device (DTensors under a
    context with a device mesh)."""
    return {n: s.zeros(META) for n, s in specs.items()}


def meta_lm(cfg: ModelConfig, **kw) -> LM:
    """:class:`LM` on the meta device, its parameters meta DTensors under
    a context with a device mesh (this rank's shards)."""
    lm = LM(cfg, device=META, **kw)
    ctx = current_ctx()
    if ctx is not None and ctx.device_mesh is not None:
        shard_params(lm, ctx)
    return lm


@contextmanager
def sharded_step(mesh: Mesh, device_type: str = "cpu") -> Iterator:
    """Rank 0 of ``mesh`` under a fake process group, with a context of
    ``mesh`` and a device mesh of ``device_type`` over it: the steps
    traced (or run on the card) inside are that rank's."""
    with fake_group(mesh.size), use_mesh(
            mesh, device_mesh=device_mesh(mesh, device_type)) as ctx:
        yield ctx


def trace_train(cfg: ModelConfig, batch: int, seq: int,
                microbatches: int = 1, tcfg: Optional[TrainConfig] = None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """One train step of ``batch`` x ``seq`` tokens in ``microbatches``,
    as ``training.make_train_step`` runs it on the card: f32 masters cast
    to the compute ``dtype`` on use, remat unless ``tcfg.remat`` is
    "none". One microbatch runs (module docstring); ``fwdbwd`` holds its
    counters apart from the update's (the result's ``out``)."""
    tcfg = tcfg or TrainConfig(microbatches=microbatches)
    lm = meta_lm(cfg, dtype=dtype, param_dtype=torch.float32)
    params = dict(lm.named_parameters())
    opt = init_opt_state(params)
    data = on_meta(batch_specs(cfg, batch, seq, "train"))
    order = leaf_order(params, cfg)

    def step(tracker, params, opt, data):
        for p in params.values():
            p.requires_grad_(True)
            # the earlier microbatches' sum, which the card's later
            # microbatches accumulate into
            p.grad = torch.zeros_like(p) if microbatches > 1 else None
        n = batch // microbatches
        loss = lm.loss(data["tokens"][:n], data["targets"][:n],
                       z_loss=tcfg.z_loss,
                       embeds=data["embeds"][:n] if "embeds" in data
                       else None, remat=tcfg.remat != "none")
        loss.backward()
        del loss
        zero_missing_grads(params)
        place_grads(params)
        fwdbwd = (tracker.op_bytes, dict(tracker.flops), len(tracker.calls),
                  {k: dict(c) for k, c in tracker.collectives.items()})
        grads = {name: p.grad for name, p in params.items()}
        for g in grads.values():
            g.div_(microbatches)
        adamw_update(params, grads, opt, tcfg, order)
        return fwdbwd

    res = trace(step, (params, opt, data))
    state = _nbytes((params, opt["m"], opt["v"]))
    res.update(out_bytes=state, alias_bytes=state)
    return res


def trace_prefill(cfg: ModelConfig, batch: int, seq: int,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """``LM.prefill`` of a (B, S) prompt into a new cache of S positions,
    the serving layout (matmul weights in the compute ``dtype``)."""
    lm = meta_lm(cfg, dtype=dtype)
    data = on_meta(batch_specs(cfg, batch, seq, "prefill"))

    def step(tracker, params, data):
        with torch.no_grad():
            return lm.prefill(data["tokens"], seq, embeds=data.get("embeds"))

    res = trace(step, (dict(lm.named_parameters()), data))
    res.update(out_bytes=_nbytes(res["out"]), alias_bytes=0)
    return res


def trace_decode(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """One ``LM.decode_step`` of B tokens over a cache of ``max_len``
    positions (``new_cache``), written in place (donated); the compute
    ``dtype`` as :func:`trace_prefill`'s."""
    lm = meta_lm(cfg, dtype=dtype)
    cache = lm.new_cache(batch, max_len)
    data = on_meta(batch_specs(cfg, batch, max_len, "decode"))

    def step(tracker, params, cache, data):
        with torch.no_grad():
            return lm.decode_step(data["token"], cache, data["pos"])

    res = trace(step, (dict(lm.named_parameters()), cache, data))
    held = _nbytes(cache)
    res.update(out_bytes=_nbytes(res["out"][0]) + held, alias_bytes=held)
    return res


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """What ``LM.new_cache(batch, max_len)`` allocates on the card, from
    ``cache_specs``."""
    return sum(alloc_bytes(s.nbytes)
               for s in cache_specs(cfg, batch, max_len, dtype).values())


# -- FLOPs --------------------------------------------------------------------------

def n_active_params(cfg: ModelConfig, n_params: int) -> int:
    """JAX's dry run's count: an MoE layer's experts past top_k left out."""
    if not cfg.n_experts:
        return n_params
    expert = 3 * cfg.d_model * cfg.d_ff
    moe_layers = cfg.n_layers - cfg.first_k_dense
    return n_params - moe_layers * (cfg.n_experts - cfg.top_k) * expert


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> int:
    """JAX's MODEL_FLOPS: 6 N D for train, 2 N D a processed token for
    serving (N the active parameters)."""
    tokens = batch if kind == "decode" else batch * seq
    return (6 if kind == "train" else 2) * \
        n_active_params(cfg, count_params(cfg)) * tokens


def train_flops(cfg: ModelConfig, tokens: int, seq: int) -> dict:
    """Model FLOPs of a train step (no remat recomputation), by part:
    "matmul", 6 per matmul parameter a token (the transformer families'
    q, k, v, o at GQA's widths and the MLP's three; zamba2's Mamba layers'
    in, B, C, dt and out projections and its shared block once for each
    of its applications; rwkv6's r, k, v, g, o, decay LoRA and channel
    mix; and the head); "attention", 4 hd flops a (query head, attended
    pair) forward, three times (forward, backward): causal pairs for a
    global layer and zamba2's shared block, pairs within the window for a
    local one; "scan", the scans' forward flops three times: zamba2's
    chunked SSD form (C B^T once a B/C group, 2 ds a live pair; P X, 2 hd
    a pair; C H^T and the state update, 4 hd ds a step, a head) and
    rwkv6's recurrence (4 hd^2 a step and head)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    kind = family_kind(cfg)
    seqs = tokens / seq
    causal = seq * (seq + 1) // 2
    attn = scan = 0.0
    if kind == "zamba":
        d_in, nh, hd, ds = ssm_dims(cfg)
        shared = zamba_groups(cfg)[0]
        H, KV, ahd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        ssm = d * 2 * d_in + 2 * d * ds + d * nh + d_in * d
        block = d * ahd * (2 * H + 2 * KV) + 3 * d * cfg.d_ff
        matmul = L * ssm + shared * block + d * V
        attn = shared * 3 * 4 * H * ahd * causal * seqs
        chunk = min(cfg.ssm_chunk, seq)
        fwd = 0
        for t0 in range(0, seq, chunk):
            n = min(chunk, seq - t0)
            pairs = n * (n + 1) // 2
            fwd += pairs * 2 * ds + nh * (pairs * 2 * hd + n * 4 * hd * ds)
        scan = 3 * L * fwd * seqs
    elif kind == "rwkv":
        nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        matmul = L * (5 * d * d + 2 * d * LORA + 2 * d * cfg.d_ff) + d * V
        scan = 3 * L * nh * 4 * hd * hd * tokens
    else:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        per_layer = d * hd * (2 * H + 2 * KV) + 3 * d * cfg.d_ff
        matmul = L * per_layer + d * V
        windows = ([0 if glob else cfg.local_window for glob, _ in
                    lg_layers(cfg)] if kind == "local_global" else [0] * L)
        attn = sum(3 * 4 * H * hd * costs.attended_pairs(seq, w)
                   for w in windows) * seqs
    return {"matmul": 6 * matmul * tokens, "attention": attn, "scan": scan}


# -- cells ----------------------------------------------------------------------------

def arg_specs(cfg: ModelConfig, kind: str, batch: int, seq: int) -> dict:
    """The step's arguments described without storage: parameters (f32
    masters for training, the serving layout otherwise), the optimizer
    state or the decode cache, and the batch."""
    if kind == "train":
        p = param_specs(cfg, torch.float32)
        opt = opt_state_specs(p)
        return {"params": p, "m": opt["m"], "v": opt["v"],
                "batch": batch_specs(cfg, batch, seq, kind)}
    out = {"params": param_specs(cfg, torch.bfloat16),
           "batch": batch_specs(cfg, batch, seq, kind)}
    if kind == "decode":
        out["cache"] = cache_specs(cfg, batch, seq)
    return out


def arg_bytes_per_device(specs: dict, ctx: Optional[ShardingCtx]) -> int:
    return sum(alloc_bytes(s.bytes_per_device(ctx))
               for group in specs.values() for s in group.values())


def run_cell(arch: str, shape_name: str, mesh_name: str = "single", *,
             layers: int = 0, batch: int = 0, microbatches: int = 0) -> dict:
    """One cell's JSON (module docstring). ``layers`` cuts the depth,
    ``batch`` replaces the shape's global batch, ``microbatches`` the
    train step's count (default 1, JAX's ``TrainConfig``)."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    B, S = batch or shape.global_batch, shape.seq_len
    mb = microbatches or 1
    if shape.kind == "train" and B % mb:
        raise ValueError(f"batch {B} does not split into {mb} microbatches")
    mesh = mesh_preset(mesh_name)
    chips = mesh.size
    n_params = count_params(cfg)
    out = {**head, "status": "ok", "chips": chips,
           "n_layers": cfg.n_layers, "batch": B, "seq_len": S,
           "microbatches": mb if shape.kind == "train" else None,
           "n_params": n_params,
           "n_active_params": n_active_params(cfg, n_params),
           "model_flops": model_flops(cfg, shape.kind, B, S),
           "xla_flops": None, "xla_bytes": None, "compile_s": None,
           "collectives": {}}
    with use_mesh(mesh) as ctx:
        specs = arg_specs(cfg, shape.kind, B, S)
        out["mem_arg_bytes"] = arg_bytes_per_device(specs, ctx)
        out["fresh_process_bytes"] = fresh_process_bytes(specs, ctx,
                                                         shape.kind)
    t0 = time.time()
    with sharded_step(mesh) if chips > 1 else nullcontext():
        if shape.kind == "train":
            res = trace_train(cfg, B, S, mb)
        elif shape.kind == "prefill":
            res = trace_prefill(cfg, B, S)
        else:
            res = trace_decode(cfg, B, S)
    out["lower_s"] = round(time.time() - t0, 2)
    # aten flops at their dtype's rate, kernels' at their own
    flops = defaultdict(float, res["flops"])
    kernel_bytes = 0.0
    by_kernel: dict = defaultdict(lambda: [0, 0.0, 0.0])
    calls = res["kernels"]
    op_bytes = res["op_bytes"]
    coll = {k: dict(c) for k, c in res["collectives"].items()}
    if shape.kind == "train":
        op_fb, flops_fb, n_fb, coll_fb = res["out"]
        # the microbatch's counts times the count, the update's once
        op_bytes += (mb - 1) * op_fb
        for rate, f in flops_fb.items():
            flops[rate] += (mb - 1) * f
        for kind, c in coll_fb.items():
            for key in ("count", "bytes"):
                coll[kind][key] += (mb - 1) * c[key]
        weights = [mb] * n_fb + [1] * (len(calls) - n_fb)
        out["counts_note"] = (
            f"one microbatch of {B // mb} rows ran on meta; its flops and "
            f"bytes are counted {mb} times, the update's once; the peak is "
            "that microbatch's (the gradient accumulator live) or the "
            "update's")
    else:
        weights = [1] * len(calls)
    for (name, nbytes, f, rate), w in zip(calls, weights):
        flops[rate] += w * f
        kernel_bytes += w * nbytes
        k = by_kernel[name]
        k[0] += w
        k[1] += w * f
        k[2] += w * nbytes
    flops_dev = sum(flops.values())
    bytes_dev = op_bytes + kernel_bytes
    coll_bytes = sum(c["bytes"] for c in coll.values())
    peak = res["peak"]
    temp = peak - res["arg"] - (res["out_bytes"] - res["alias_bytes"])
    out.update(
        mem_arg_bytes=res["arg"], mem_temp_bytes=temp,
        mem_out_bytes=res["out_bytes"], mem_alias_bytes=res["alias_bytes"],
        peak_bytes=peak,
        fits=peak + out["fresh_process_bytes"] <= HBM_USABLE,
        hlo_flops_dev=flops_dev, hlo_bytes_dev=bytes_dev,
        coll_bytes_dev=coll_bytes, collectives=coll,
        kernels={n: {"calls": c, "flops": f, "bytes": b}
                 for n, (c, f, b) in by_kernel.items()},
        t_compute=sum(f / rate for rate, f in flops.items()),
        t_memory=bytes_dev / HBM_BW, t_collective=coll_bytes / NVLINK_BW,
        useful_flops_ratio=(out["model_flops"] / (flops_dev * chips)
                            if flops_dev else None))
    terms = {"compute": out["t_compute"], "memory": out["t_memory"],
             "collective": out["t_collective"]}
    out["bottleneck"] = max(terms, key=terms.get)
    out["roofline_fraction"] = (max(terms["compute"], 1e-30)
                                / max(sum(terms.values()), 1e-30))
    return out


def cell_tag(arch: str, shape: str, mesh: str, layers: int = 0,
             batch: int = 0, microbatches: int = 0) -> str:
    tag = f"{arch}__{shape}__{mesh}"
    cut = "".join(f"_{k}{v}" for k, v in (("L", layers), ("B", batch),
                                          ("mb", microbatches)) if v)
    return tag + (f"__{cut[1:]}" if cut else "")


def deepest_fit(arch: str, shape_name: str = "train_4k", *, batch: int = 0,
                microbatches: int = 0, mesh: str = "single"
                ) -> tuple[int, Optional[int]]:
    """(the most layers, up to the config's own, whose step fits one
    device of ``mesh`` (``fits``: the peak and what a fresh process holds
    beyond it within ``HBM_USABLE``), that peak in bytes or None where
    even one layer does not fit): a bisection over the depth, the peak
    growing with it."""
    def cell(layers):
        return run_cell(arch, shape_name, mesh, layers=layers, batch=batch,
                        microbatches=microbatches)
    lo, hi = 0, get_config(arch).n_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if cell(mid)["fits"]:
            lo = mid
        else:
            hi = mid - 1
    return lo, (cell(lo)["peak_bytes"] if lo else None)


def cell_line(res: dict) -> str:
    """One cell's figures on a line: argument, temp and peak GB, fits,
    TFLOP, bottleneck."""
    def gb(key):
        v = res.get(key)
        return "-" if v is None else f"{v / 1e9:.3f}"
    flops = res.get("hlo_flops_dev")
    return (f"arg {gb('mem_arg_bytes')} GB, temp {gb('mem_temp_bytes')} GB, "
            f"peak {gb('peak_bytes')} GB, fits {res.get('fits')}, "
            f"{'-' if flops is None else f'{flops / 1e12:.1f}'} TFLOP, "
            f"bottleneck {res.get('bottleneck')}")


SUMMARY = ("arch", "shape", "mesh", "status", "reason", "lower_s",
           "mem_arg_bytes", "mem_temp_bytes", "peak_bytes", "fits",
           "hlo_flops_dev", "coll_bytes_dev", "t_compute", "t_memory",
           "t_collective", "bottleneck", "useful_flops_ratio")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=list(MESHES) + ["both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--batch", type=int, default=0,
                    help="the global batch (0: the shape's)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="a train step's microbatches (0: 1)")
    ap.add_argument("--deepest", action="store_true",
                    help="print the most layers of --arch whose --shape "
                    "step fits one device of --mesh (mesh.HBM_USABLE)")
    args = ap.parse_args(argv)
    if args.deepest:
        if not (args.arch and args.shape) or args.mesh == "both":
            ap.error("--deepest needs --arch, --shape and one --mesh")
        layers, peak = deepest_fit(args.arch, args.shape, batch=args.batch,
                                   microbatches=args.microbatches,
                                   mesh=args.mesh)
        print(f"{args.arch} {args.shape} {args.mesh} batch "
              f"{args.batch or 'default'} microbatches "
              f"{args.microbatches or 1}: {layers} of "
              f"{get_config(args.arch).n_layers} layers fit "
              f"{HBM_USABLE / 1e9:.3f} GB a device"
              + (f", peak {peak / 1e9:.3f} GB" if peak else ""), flush=True)
        return
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    cut = dict(layers=args.layers, batch=args.batch,
               microbatches=args.microbatches)
    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in meshes]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, m) for m in meshes]
    else:
        ap.error("give --arch and --shape, or --all")
    failures = 0
    t_all = time.time()
    for a, s, m in cells:
        tag = cell_tag(a, s, m, **cut)
        path = outdir / f"{tag}.json"
        if args.all and path.exists() and not args.overwrite:
            print(f"[skip-cached] {tag}", flush=True)
            continue
        t0 = time.time()
        try:
            res = run_cell(a, s, m, **cut)
        except Exception:            # one cell's failure ends no other
            failures += 1
            (outdir / f"{tag}.err").write_text(traceback.format_exc())
            print(f"[FAIL {time.time() - t0:6.1f}s] {tag}", flush=True)
            continue
        path.write_text(json.dumps(res, indent=2))
        if args.all:
            print(f"[ok   {time.time() - t0:6.1f}s] {tag}: "
                  + (cell_line(res) if res["status"] == "ok"
                     else res["reason"]), flush=True)
        else:
            print(json.dumps({k: res.get(k) for k in SUMMARY}, indent=2))
    if args.all:
        print(f"done, {failures} failures, {time.time() - t_all:.1f} s",
              flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
