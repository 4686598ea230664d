"""The dry run on the meta device (``repro_torch.launch.dryrun``) and the
kernels' meta route, held against the JAX package on the CPU.

* parameter counts, optimizer-state bytes and decode-cache bytes equal
  JAX's ``count_params(model_specs(cfg))``, ``opt_state_specs`` and
  ``cache_specs`` for all 10 archs (every applicable shape for caches);
* a dry run of each family, at full width cut in depth, returns the
  keys of JAX's ``_cell`` (read from its source), JAX's parameter and
  model-flop counts, and holds no CPU or CUDA storage beyond its
  bookkeeping;
* on meta each kernel wrapper, forward and backward, returns the
  outputs and saves the tensors its CUDA contract states, allocates
  exactly its CUDA call's outputs and workspaces (the peak, at the
  allocator's 512-byte rounding), records the bytes and flops of
  ``kernels/costs.py`` and counts no launch; a CPU tensor still takes
  the plain version.

Exact comparisons throughout: everything here is counted, not computed.
"""
import ast
import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import count_params as jcount_params
from repro.models import cache_specs as jcache_specs
from repro.models import model_specs
from repro.training.optimizer import opt_state_specs as jopt_state_specs
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.kernels import costs, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_rmsnorm as rn
from repro_torch.kernels import rwkv6_scan as rs
from repro_torch.kernels import ssm_scan as ss
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import NVLINK_BW, mesh_preset
from repro_torch.models import LM, cache_specs
from repro_torch.params import count_params, param_specs
from repro_torch.training import opt_state_specs

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
BF, F32 = torch.bfloat16, torch.float32


def jax_bytes(tree) -> int:
    from repro.distributed.params import is_spec
    import jax
    return sum(math.prod(p.shape) * jnp.dtype(p.dtype).itemsize
               for p in jax.tree.leaves(tree, is_leaf=is_spec))


def jax_cell_keys() -> set:
    """The keys JAX's ``_cell`` writes into a cell's result
    (``src/repro/launch/dryrun.py``): its ``out = {...}`` literal and each
    ``out["..."] =`` after it."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    cell = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_cell")
    keys = set()
    for node in ast.walk(cell):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name) \
                and node.targets[0].id == "out" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Subscript) \
                and getattr(node.targets[0].value, "id", "") == "out":
            keys.add(node.targets[0].slice.value)
    return keys


# -- counts against JAX -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_is_jax_s(arch):
    n = count_params(get_config(arch))
    assert n == jcount_params(model_specs(jget_config(arch)))
    assert n == sum(s.numel for s in param_specs(get_config(arch)).values())
    # an LM on meta holds exactly those parameters
    lm = LM(get_config(arch), device=META)
    assert sum(p.numel() for p in lm.parameters()) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_bytes_are_jax_s(arch):
    specs = opt_state_specs(param_specs(get_config(arch), F32))
    ours = sum(s.nbytes for group in ("m", "v")
               for s in specs[group].values()) + specs["step"].nbytes
    assert ours == jax_bytes(jopt_state_specs(model_specs(jget_config(arch))))
    assert specs["step"].dtype == torch.int32 and specs["step"].shape == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_new_cache_bytes_are_jax_s(arch):
    """``new_cache`` at the serving dtype (bf16 KV, f32 states) holds
    JAX's ``cache_specs`` bytes at every applicable shape; the port's
    leaves merge JAX's layer stacks (its docstring), so only the totals
    compare. ``dryrun.cache_bytes`` is what the allocator holds for it."""
    cfg = get_config(arch)
    lm = LM(cfg, device=META)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        B, S = shape.global_batch, shape.seq_len
        cache = lm.new_cache(B, S)
        ours = sum(t.numel() * t.element_size() for t in cache.values())
        assert ours == jax_bytes(jcache_specs(jget_config(arch), B, S)), name
        assert ours == sum(s.nbytes for s in cache_specs(cfg, B, S).values())
        assert {n: (tuple(t.shape), t.dtype) for n, t in cache.items()} == \
            {n: (s.shape, s.dtype) for n, s in cache_specs(cfg, B, S).items()}
        assert dryrun.cache_bytes(cfg, B, S) == sum(
            dryrun.alloc_bytes(t.untyped_storage().nbytes())
            for t in cache.values())


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-3b-a800m"])
def test_param_bytes_per_device_follow_the_specs(arch):
    """Each parameter's bytes on one device of the quad mesh: its bytes
    over the devices its resolved spec splits it across (the stacked
    layer axes never split); on one card, all of them."""
    from repro_torch.distributed.sharding import spec_shards, use_mesh
    from repro_torch.launch.mesh import mesh_preset
    from repro_torch.params import param_bytes_per_device, param_specs_pspec
    cfg = get_config(arch)
    specs = param_specs(cfg)
    with use_mesh(mesh_preset("quad")) as ctx:
        per_dev = param_bytes_per_device(cfg, ctx)
        pspecs = param_specs_pspec(cfg)
        assert {n: specs[n].nbytes // spec_shards(pspecs[n], ctx)
                for n in specs} == per_dev
    assert sum(per_dev.values()) < sum(s.nbytes for s in specs.values())
    assert param_bytes_per_device(cfg) == {n: s.nbytes
                                           for n, s in specs.items()}


def test_alloc_bytes_rounds_to_the_allocators_blocks():
    assert [dryrun.alloc_bytes(n) for n in (0, 1, 512, 513, 4096)] == \
        [0, 512, 512, 1024, 4096]


def test_a_fresh_process_holds_segment_remainders_and_workspaces():
    """A segment made for a request of 10 MiB or more is the request
    rounded up to 2 MiB, and a remainder of at most 1 MiB stays with the
    block: deepseek-7b's MLP shards on quad, 4096 x 2752 f32 (43 MiB), and
    their two moments hold 44 MiB each in a fresh process, 9 MiB a layer
    (the card's rank-0 peak above the dry run's, with a cuBLAS workspace
    for each of the train step's two threads); moonshot's shards are
    whole multiples of 2 MiB."""
    MiB = 2**20
    assert [dryrun.segment_bytes(n) for n in (
        9 * MiB + 1, 42 * MiB, 43 * MiB, 43 * MiB + 512 * 1024,
        43 * MiB - 512)] == [9 * MiB + 512, 42 * MiB, 44 * MiB, 44 * MiB,
                             43 * MiB - 512]    # 1 MiB + 512 split off
    assert dryrun.segment_bytes(41 * MiB + 1) == 42 * MiB
    assert dryrun.segment_bytes(40 * MiB + 1) == 40 * MiB + 512
    quad = mesh_preset("quad")
    for arch, kind, layers, want in (
            ("deepseek-7b", "train", 30, 270 * MiB + 2 * 32 * MiB),
            ("moonshot-v1-16b-a3b", "train", 33, 2 * 32 * MiB),
            ("moonshot-v1-16b-a3b", "decode", 48, 32 * MiB)):
        cfg = get_config(arch).with_(n_layers=layers)
        specs = dryrun.arg_specs(cfg, kind, 4, 4096)
        with use_mesh(quad) as ctx:
            assert dryrun.fresh_process_bytes(specs, ctx, kind) == want


# -- dry runs of each family --------------------------------------------------------

FAMILIES = {"deepseek-7b": 2, "granite-moe-3b-a800m": 2, "gemma3-12b": 6,
            "zamba2-1.2b": 6, "rwkv6-1.6b": 2, "qwen2-vl-2b": 2}


class CpuSpy(dryrun.MetaTracker):
    """Also adds up the CPU tensors the ops make."""
    cpu_bytes = 0

    def _hold(self, t):
        if t.device.type == "cpu":
            CpuSpy.cpu_bytes += t.numel() * t.element_size()
        super()._hold(t)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_dry_run_of_each_family(arch, monkeypatch):
    monkeypatch.setattr(dryrun, "MetaTracker", CpuSpy)
    CpuSpy.cpu_bytes = 0
    layers = FAMILIES[arch]
    jcfg = jget_config(arch).with_(n_layers=layers)
    keys = jax_cell_keys()
    assert {"mem_temp_bytes", "hlo_flops_dev", "roofline_fraction"} <= keys
    ops.reset_launch_counts()
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        kw = dict(layers=layers, batch=2,
                  microbatches=2 if shape == "train_4k" else 0)
        res = dryrun.run_cell(arch, shape, "single", **kw)
        assert keys <= set(res), keys - set(res)
        n = jcount_params(model_specs(jcfg))
        assert res["n_params"] == n
        if jcfg.n_experts:           # JAX's formula (launch/dryrun.py)
            ep = 3 * jcfg.d_model * jcfg.d_ff
            moe = jcfg.n_layers - jcfg.first_k_dense
            n = n - moe * jcfg.n_experts * ep + moe * jcfg.top_k * ep
        assert res["n_active_params"] == n
        kind = SHAPES[shape].kind
        tokens = 2 if kind == "decode" else 2 * SHAPES[shape].seq_len
        assert res["model_flops"] == (6 if kind == "train" else 2) * n * tokens
        assert res["status"] == "ok" and res["fits"] is True
        assert res["peak_bytes"] >= res["mem_arg_bytes"] > 0
        assert res["mem_temp_bytes"] > 0 and res["hlo_flops_dev"] > 0
        assert res["bottleneck"] in ("compute", "memory")
        assert res["kernels"], "no kernel took its meta route"
        # the arguments the meta step holds are the ones their specs
        # describe, which the quad mesh splits
        cfg = get_config(arch).with_(n_layers=layers)
        specs = dryrun.arg_specs(cfg, kind, 2, SHAPES[shape].seq_len)
        assert res["mem_arg_bytes"] == dryrun.arg_bytes_per_device(specs,
                                                                     None)
        quad = dryrun.run_cell(arch, shape, "quad", **kw)
        assert keys <= set(quad)
        # every family runs the sharded step
        assert quad.get("reason") is None
        assert quad["mem_temp_bytes"] > 0 and quad["t_collective"] > 0
        assert 0 < quad["mem_arg_bytes"] < res["mem_arg_bytes"]
    assert all(v == 0 for v in ops.launch_counts().values())
    assert CpuSpy.cpu_bytes < 1 << 20     # bookkeeping only (index tables)


DENSE = ("deepseek-7b", "deepseek-67b")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", DENSE)
def test_quad_cell_of_a_dense_stack(arch, shape):
    """The sharded step's quad cell, 2 layers at batch 2: the per-device
    figures are filled; the arguments are the resolver's bytes; the
    flops are one device's. Bound on the flops: every matmul and the
    attention kernels split four ways (heads, MLP, vocabulary) and the
    collectives add none (their bytes are counted apart), while each norm
    runs on whole rows on every rank, so 4 x the device's flops must
    equal the single card's plus 3 x its norm kernels' flops."""
    kw = dict(layers=2, batch=2,
              microbatches=2 if shape == "train_4k" else 0)
    single = dryrun.run_cell(arch, shape, "single", **kw)
    quad = dryrun.run_cell(arch, shape, "quad", **kw)
    for key in ("peak_bytes", "mem_temp_bytes", "hlo_flops_dev",
                "hlo_bytes_dev", "coll_bytes_dev", "t_collective"):
        assert quad[key] is not None and quad[key] > 0, key
    assert quad["fits"] is True and quad["bottleneck"] is not None
    assert set(quad["collectives"]) == {"all-reduce"}
    assert quad["collectives"]["all-reduce"]["bytes"] == quad["coll_bytes_dev"]
    assert quad["t_collective"] == quad["coll_bytes_dev"] / NVLINK_BW
    cfg = get_config(arch).with_(n_layers=2)
    specs = dryrun.arg_specs(cfg, SHAPES[shape].kind, 2,
                             SHAPES[shape].seq_len)
    with use_mesh(mesh_preset("quad")) as ctx:
        assert quad["mem_arg_bytes"] == dryrun.arg_bytes_per_device(specs,
                                                                    ctx)
    norms = sum(k["flops"] for n, k in single["kernels"].items()
                if n.startswith("fused_rmsnorm"))
    assert 4 * quad["hlo_flops_dev"] == single["hlo_flops_dev"] + 3 * norms
    assert quad["kernels"].keys() == single["kernels"].keys()
    # the single card's cell is the unsharded step: no collective
    assert single["collectives"] == {} and single["coll_bytes_dev"] == 0
    assert single["t_collective"] == 0.0 and "reason" not in single
    assert quad["peak_bytes"] < single["peak_bytes"]


MOE_ARCHS = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")


def repeated_flops(cfg, kind: str, batch: int, seq: int,
                   microbatches: int) -> int:
    """The matmul flops every rank of quad repeats beside the norms: the
    router's product (B, S, d) x (d, E), replicated as JAX keeps it, in
    the forward (a train microbatch's twice: the forward and the remat
    recomputation; its backward runs on rows DTensor splits), and in
    prefill and decode the head (d, V) where the vocabulary does not
    divide the model axis (granite-moe's 49,155; a train step's CE splits
    its rows instead)."""
    tokens = batch * (1 if kind == "decode" else seq)
    moe_layers = cfg.n_layers - cfg.first_k_dense
    router = 2 * tokens * cfg.d_model * cfg.n_experts * moe_layers
    if kind == "train":
        return 2 * router
    # prefill's and decode's head, on each row's last position
    head = 2 * batch * cfg.d_model * cfg.vocab if cfg.vocab % 4 else 0
    return router + head


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_quad_cell_of_a_moe_stack(arch, shape, monkeypatch):
    """The sharded step's quad cell of a MoE stack, 2 layers at batch 2:
    the per-device figures are filled; the arguments are the resolver's
    bytes; the flops are one device's. Bound on the flops: the attention
    kernels, the projections, the dense head layer's MLP and the experts
    (E / 4 a rank) split four ways, the collectives add none, and the
    norms and :func:`repeated_flops` run whole on every rank, so 4 x the
    device's flops equal the single card's plus 3 x those. The prefill
    cell shows the dispatch buffer (B, E, C, d) at a quarter on rank 0:
    the buffer the layer builds there is (B, E / 4, C, d), and rank 0's
    temp bytes are less than the single card's by more than three
    quarters of the buffer and the expert output together."""
    from repro_torch.models import layers
    kw = dict(layers=2, batch=2,
              microbatches=2 if shape == "train_4k" else 0)
    kind, seq = SHAPES[shape].kind, SHAPES[shape].seq_len
    cfg = get_config(arch).with_(n_layers=2)
    single = dryrun.run_cell(arch, shape, "single", **kw)
    built = []
    dispatch = layers.dispatch

    def spy(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        built.append(tuple(out[0].shape))
        return out
    monkeypatch.setattr(layers, "dispatch", spy)
    quad = dryrun.run_cell(arch, shape, "quad", **kw)
    for key in ("peak_bytes", "mem_temp_bytes", "hlo_flops_dev",
                "hlo_bytes_dev", "coll_bytes_dev", "t_collective"):
        assert quad[key] is not None and quad[key] > 0, key
    assert quad["fits"] is True and quad["bottleneck"] is not None
    assert "reason" not in quad and "all-reduce" in quad["collectives"]
    assert sum(c["bytes"] for c in quad["collectives"].values()) == \
        quad["coll_bytes_dev"]
    assert quad["t_collective"] == quad["coll_bytes_dev"] / NVLINK_BW
    specs = dryrun.arg_specs(cfg, kind, 2, seq)
    with use_mesh(mesh_preset("quad")) as ctx:
        assert quad["mem_arg_bytes"] == dryrun.arg_bytes_per_device(specs,
                                                                    ctx)
    norms = sum(k["flops"] for n, k in single["kernels"].items()
                if n.startswith("fused_rmsnorm"))
    mb = kw["microbatches"] or 1
    assert 4 * quad["hlo_flops_dev"] == single["hlo_flops_dev"] + 3 * (
        norms + mb * repeated_flops(cfg, kind, 2 // mb, seq, mb))
    assert quad["kernels"].keys() == single["kernels"].keys()
    assert quad["peak_bytes"] < single["peak_bytes"]
    E, d = cfg.n_experts, cfg.d_model
    C = layers.capacity(cfg, 1 if kind == "decode" else seq)
    assert built and set(built) == {(2 // mb, E // 4, C, d)}
    if kind == "prefill":
        buf = 2 * E * C * d * 2                  # bf16
        assert single["mem_temp_bytes"] - quad["mem_temp_bytes"] \
            > 3 * (2 * buf) // 4


def test_deepest_fit_takes_the_mesh(monkeypatch):
    """``deepest_fit(mesh=)`` bisects the depth on one device of the mesh
    it is given, on ``run_cell``'s ``fits`` (a stand-in cell whose peak
    grows 10 GB a layer less 0.5 GB, and a fresh process holds 1 GB
    beyond it: 7 layers fit 80 GB, where the peak alone would let 8)."""
    seen = []

    def cell(arch, shape, mesh, *, layers, batch, microbatches):
        seen.append((mesh, layers))
        peak, fresh = layers * 10_000_000_000 - 500_000_000, 1_000_000_000
        return {"peak_bytes": peak, "fresh_process_bytes": fresh,
                "fits": peak + fresh <= dryrun.HBM_USABLE}
    monkeypatch.setattr(dryrun, "run_cell", cell)
    layers_, peak = dryrun.deepest_fit("moonshot-v1-16b-a3b", mesh="quad",
                                       batch=4, microbatches=2)
    assert (layers_, peak) == (7, 69_500_000_000)
    assert {m for m, _ in seen} == {"quad"}


#: the local_global and scan stacks, at the depth their quad cell runs:
#: gemma3's first group of 5 local layers and its global one, zamba2's
#: first group of 6 Mamba layers and its shared block, 2 rwkv6 layers
RING_SCAN = {"gemma3-12b": 6, "gemma3-27b": 6, "zamba2-1.2b": 6,
             "rwkv6-1.6b": 2}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", list(RING_SCAN))
def test_quad_cell_of_a_ring_or_scan_stack(arch, shape):
    """The sharded step's quad cell of gemma3's rings and of the scan
    stacks at batch 2: the per-device figures are filled, the arguments
    are the resolver's bytes, the collectives' bytes are
    ``coll_bytes_dev``, and each kernel ran on rank 0's shards
    (``common.local_calls``): the scans on a quarter of the heads (ssm:
    xbar (B, nh / 4, S, hd), B and C whole (B, S, ds); rwkv6: r, k, v, w
    (B, nh / 4, S, hd), u (nh / 4, hd)), attention on a quarter of the
    KV heads, gemma3's local layers at the window, decode over the rings
    and the whole cache, and every norm on whole rows (d, zamba2's out
    norm d_inner). The flops are one device's: less than the single
    card's (the projections and kernels split), at least a quarter of
    them."""
    from repro_torch.kernels import common
    from repro_torch.models.rwkv import rwkv_dims
    from repro_torch.models.ssm import ssm_dims
    layers = RING_SCAN[arch]
    kw = dict(layers=layers, batch=2,
              microbatches=2 if shape == "train_4k" else 0)
    kind, seq = SHAPES[shape].kind, SHAPES[shape].seq_len
    cfg = get_config(arch).with_(n_layers=layers)
    single = dryrun.run_cell(arch, shape, "single", **kw)
    with common.local_calls() as calls:
        quad = dryrun.run_cell(arch, shape, "quad", **kw)
    for key in ("peak_bytes", "mem_temp_bytes", "hlo_flops_dev",
                "hlo_bytes_dev", "coll_bytes_dev", "t_collective"):
        assert quad[key] is not None and quad[key] > 0, key
    assert quad["fits"] is True and "reason" not in quad
    assert "all-reduce" in quad["collectives"]
    assert sum(c["bytes"] for c in quad["collectives"].values()) == \
        quad["coll_bytes_dev"]
    assert quad["t_collective"] == quad["coll_bytes_dev"] / NVLINK_BW
    specs = dryrun.arg_specs(cfg, kind, 2, seq)
    with use_mesh(mesh_preset("quad")) as ctx:
        assert quad["mem_arg_bytes"] == dryrun.arg_bytes_per_device(specs,
                                                                    ctx)
    assert quad["kernels"].keys() == single["kernels"].keys()
    assert single["hlo_flops_dev"] / 4 <= quad["hlo_flops_dev"] \
        < single["hlo_flops_dev"]
    assert quad["peak_bytes"] < single["peak_bytes"]
    b = 1 if kind == "train" else 2          # a microbatch's rows
    got = {}
    for name, args, keys in calls:
        got.setdefault(name, set()).add((tuple(s for s, _ in args),
                                         dict(keys).get("window")))
    assert {n for n in quad["kernels"] if not n.endswith("_bwd")
            and not n.startswith("flash_bwd")} == set(got)
    d_in = ssm_dims(cfg)[0] if arch.startswith("zamba") else cfg.d_model
    assert {s[0][-1] for s, _ in got["fused_rmsnorm"]} <= {cfg.d_model, d_in}
    assert all(s[1] == (s[0][-1],) for s, _ in got["fused_rmsnorm"])
    if arch.startswith("zamba"):
        _, nh, hd, ds = ssm_dims(cfg)
        if kind != "decode":
            assert got["ssm_scan"] == {(((b, nh // 4, seq, hd),
                                         (b, seq, ds), (b, seq, ds),
                                         (b, nh // 4, seq)), None)}
    elif arch.startswith("rwkv"):            # no attention
        nh, hd = rwkv_dims(cfg)
        r = (b, nh // 4, seq, hd)
        assert got.get("rwkv6_scan") == (
            None if kind == "decode" else {((r, r, r, r, (nh // 4, hd)),
                                            None)})
        return
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (b, KV // 4, H // KV, 1 if kind == "decode" else seq, hd)
    if kind == "decode":
        lengths = {s[1][2] for s, _ in got["decode_attention"]}
        assert {s[0] for s, _ in got["decode_attention"]} == {q}
        assert lengths == ({cfg.local_window, seq} if arch.startswith(
            "gemma3") else {seq})
    else:
        kv = (b, KV // 4, seq, hd)
        windows = {0, cfg.local_window} if arch.startswith("gemma3") \
            else {0}
        assert got["flash_attention"] == {((q, kv, kv), w) for w in windows}


FRONTEND = ("qwen2-vl-2b", "musicgen-large")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_quad_cell_of_a_frontend_stack(arch, shape):
    """The sharded step's quad cell of the frontend archs, 2 layers at
    batch 2, fed the frontend's embeddings (``batch_specs``): the
    per-device figures are filled, the arguments are the resolver's bytes,
    the collectives' bytes are ``coll_bytes_dev``, and each kernel ran on
    rank 0's shards (``common.local_calls``). qwen2-vl's 2 KV heads do not
    divide the model axis: flash takes each rank's 3 query heads over its
    own KV head, q (b, 3, S, hd) over k (b, 1, S, hd); decode takes all 12
    query heads over the rank's quarter of the cache, q (b, 12, 1, hd)
    over (b, 2, S / 4, hd), with the log-sum-exp; the all-gathers are k's
    and v's, and in decode q's and the ranks' (o, lse). musicgen's 32 heads and KV heads split four ways, 8 a
    rank. Bound on the flops: the matmuls and the attention kernels split
    four ways (qwen2-vl's decode over a quarter of the keys), the
    collectives and the merge add none, and each norm runs on whole rows,
    so 4 x the device's flops equal the single card's plus 3 x its norm
    kernels' flops."""
    from repro_torch.kernels import common
    kw = dict(layers=2, batch=2,
              microbatches=2 if shape == "train_4k" else 0)
    kind, seq = SHAPES[shape].kind, SHAPES[shape].seq_len
    cfg = get_config(arch).with_(n_layers=2)
    single = dryrun.run_cell(arch, shape, "single", **kw)
    with common.local_calls() as calls:
        quad = dryrun.run_cell(arch, shape, "quad", **kw)
    for key in ("peak_bytes", "mem_temp_bytes", "hlo_flops_dev",
                "hlo_bytes_dev", "coll_bytes_dev", "t_collective"):
        assert quad[key] is not None and quad[key] > 0, key
    assert quad["fits"] is True and "reason" not in quad
    assert sum(c["bytes"] for c in quad["collectives"].values()) == \
        quad["coll_bytes_dev"]
    assert quad["t_collective"] == quad["coll_bytes_dev"] / NVLINK_BW
    specs = dryrun.arg_specs(cfg, kind, 2, seq)
    assert "embeds" in specs["batch"] or kind == "decode"
    with use_mesh(mesh_preset("quad")) as ctx:
        assert quad["mem_arg_bytes"] == dryrun.arg_bytes_per_device(specs,
                                                                    ctx)
    assert quad["kernels"].keys() == single["kernels"].keys()
    norms = sum(k["flops"] for n, k in single["kernels"].items()
                if n.startswith("fused_rmsnorm"))
    assert 4 * quad["hlo_flops_dev"] == single["hlo_flops_dev"] + 3 * norms
    assert quad["peak_bytes"] < single["peak_bytes"]
    b = 1 if kind == "train" else 2          # a microbatch's rows
    got = {}
    for name, args, keys in calls:
        got.setdefault(name, set()).add((tuple(s for s, _ in args),
                                         tuple(keys)))
    assert {n for n in quad["kernels"] if not n.endswith("_bwd")
            and not n.startswith("flash_bwd")} == set(got)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if arch.startswith("qwen"):
        assert (H, KV) == (12, 2)
        q_train, kv_train = (b, 3, seq, hd), (b, 1, seq, hd)
        q_decode, cache = (b, 12, 1, hd), (b, 2, seq // 4, hd)
        lse = (("with_lse", True),)
        # k and v gathered a layer (twice in a train step: the remat's
        # recomputation), and in decode q and the ranks' (o, lse) too
        gathers = {"train": 4 * 2 * 2, "prefill": 2 * 2, "decode": 4 * 2}
        assert quad["collectives"]["all-gather"]["count"] == gathers[kind]
    else:
        assert H == KV == 32
        q_train, kv_train = (b, 8, 1, seq, hd), (b, 8, seq, hd)
        q_decode, cache = (b, 8, 1, 1, hd), (b, 8, seq, hd)
        lse = ()
        assert set(quad["collectives"]) == {"all-reduce"}
    if kind == "decode":
        assert got["decode_attention"] == {(
            (q_decode, cache, cache, q_decode[:-2]),
            (("softcap", 0.0), ("window", 0)) + lse)}
    else:
        assert got["flash_attention"] == {(
            (q_train, kv_train, kv_train),
            (("causal", True), ("softcap", 0.0), ("window", 0)))}


def test_train_cell_counts_its_kernels_and_microbatches():
    """deepseek-7b, 2 layers, batch 4 in 2 microbatches: the kernels run
    as the card's train phase counts its launches (each norm and
    attention forward twice with remat, backward once), once a
    microbatch on meta, and the JSON counts them twice."""
    res = dryrun.run_cell("deepseek-7b", "train_4k", layers=2, batch=4,
                          microbatches=2)
    k = res["kernels"]
    assert k["fused_rmsnorm"]["calls"] == 2 * (2 * 2 * 2 + 1)
    assert k["fused_rmsnorm_bwd"]["calls"] == 2 * (2 * 2 + 1)
    assert k["flash_attention"]["calls"] == 2 * 2 * 2
    for name in ("flash_bwd_preprocess", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert k[name]["calls"] == 2 * 2
    fl = costs.flash(64, 64, 4096, 4096, 128, BF, lse=True)
    assert k["flash_attention"]["flops"] == 8 * fl[1]
    assert "microbatch" in res["counts_note"]


def test_remat_frees_on_meta():
    """Per-layer remat holds one layer's input a layer, not its
    activations: the peak without it is higher."""
    cfg = get_config("deepseek-7b").with_(n_layers=4)
    from repro_torch.configs import TrainConfig
    peaks = {r: dryrun.trace_train(cfg, 2, 4096, 1,
                                   TrainConfig(remat=r))["peak"]
             for r in ("block", "none")}
    assert peaks["none"] > peaks["block"] + 4 * 2 * 4096 * 4096 * 2


def test_peak_counts_live_storages():
    """Views share their storage, a tensor's storage is held while a view
    or a saved tensor holds it, and each is rounded to 512 bytes."""
    def fn(tracker):
        a = torch.empty(1000, device=META)           # 4000 -> 4096
        b = a.view(10, 100)
        del a
        c = torch.empty(10, device=META)              # 40 -> 512
        assert tracker.live == 4096 + 512
        del b, c
        x = torch.empty(100, device=META, requires_grad=True)
        y = torch.exp(x)                              # exp saves its output
        s = y.sum()
        del y
        live = tracker.live
        s.backward()                                  # frees the saved y
        del s
        return live, tracker.live
    res = dryrun.trace(fn, ())
    (saved, after) = res["out"]
    assert res["peak"] >= 4096 + 512
    assert saved == 512 * 3                           # x, y (saved), s
    assert after == 512 * 2                           # x and x.grad


def test_cli_writes_one_json_per_cell(tmp_path, capsys):
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--mesh",
                 "both", "--layers", "2", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["rwkv6-1.6b__decode_32k__quad__L2.json",
                     "rwkv6-1.6b__decode_32k__single__L2.json"]
    res = json.loads((tmp_path / names[1]).read_text())
    assert res["fits"] is True and res["n_layers"] == 2
    skipped = dryrun.run_cell("deepseek-7b", "long_500k")
    assert skipped["status"] == "skipped"


# -- the kernels' meta route --------------------------------------------------------

def meta(*shape, dtype=F32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def nb(*tensors) -> int:
    """What the allocator holds for these tensors, one block each."""
    return sum(dryrun.alloc_bytes(t.numel() * t.element_size())
               for t in tensors)


def recorded(fn):
    with costs.recording() as calls:
        out = fn()
    return out, calls


def check_saved(out, want):
    saved = out.grad_fn.saved_tensors
    assert [(tuple(t.shape), t.dtype) for t in saved] == want


def test_meta_rmsnorm():
    n, d = 64, 256
    x, w = meta(n, d, dtype=BF, grad=True), meta(d, grad=True)
    out, calls = recorded(lambda: ops.fused_rmsnorm(x, w))
    assert (tuple(out.shape), out.dtype) == ((n, d), BF)
    check_saved(out, [((n, d), BF), ((d,), F32)])
    assert calls == [("fused_rmsnorm", *costs.rmsnorm(n, d, BF))]
    dy = meta(n, d, dtype=BF)
    (dx, dw), calls = recorded(lambda: torch.autograd.grad(out, (x, w), dy))
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype) == (x.shape, BF, w.shape,
                                                        F32)
    assert calls == [("fused_rmsnorm_bwd", *costs.rmsnorm_bwd(n, d, BF))]
    x0, w0 = x.detach(), w.detach()
    assert dryrun.peak_of(lambda: rn.fused_rmsnorm_cuda(x0, w0), (x0, w0)) \
        == nb(x0)
    part = meta(rn.BWD_BLOCKS, d)
    assert dryrun.peak_of(lambda: rn.fused_rmsnorm_bwd_cuda(x0, w0, dy),
                          (x0, w0, dy)) == nb(x0, w0, part)


@pytest.mark.parametrize("window", [0, 48])
def test_meta_flash(window):
    bh, bh_kv, s, hd = 8, 4, 130, 64
    q = meta(bh, s, hd, dtype=BF, grad=True)
    k, v = (meta(bh_kv, s, hd, dtype=BF, grad=True) for _ in range(2))
    out, calls = recorded(lambda: ops.flash_attention(q, k, v, window=window))
    assert (tuple(out.shape), out.dtype) == ((bh, s, hd), BF)
    check_saved(out, [((bh, s, hd), BF), ((bh_kv, s, hd), BF),
                      ((bh_kv, s, hd), BF), ((bh, s, hd), BF),
                      ((bh, s), F32)])
    args = (bh, bh_kv, s, s, hd, BF, True, window)
    assert calls == [("flash_attention", *costs.flash(*args, lse=True))]
    do = meta(bh, s, hd, dtype=BF)
    grads, calls = recorded(lambda: torch.autograd.grad(out, (q, k, v), do))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert calls == [
        ("flash_bwd_preprocess", *costs.flash_bwd_preprocess(bh, s, hd, BF)),
        ("flash_bwd_dkdv", *costs.flash_bwd_dkdv(*args)),
        ("flash_bwd_dq", *costs.flash_bwd_dq(*args))]
    # pairs: the live pairs of the mask
    i = np.arange(s)
    keep = (i[None] <= i[:, None]) & ((i[None] > i[:, None] - window)
                                      if window else True)
    assert costs.flash_pairs(s, s, True, window) == int(keep.sum())
    qd, kd, vd = (t.detach() for t in (q, k, v))
    lse = meta(bh, s)
    assert dryrun.peak_of(lambda: ops.flash_attention(q, k, v,
                                                      window=window),
                          (q, k, v)) == nb(qd, lse)
    assert dryrun.peak_of(lambda: fa.flash_bwd_preprocess_cuda(qd, do),
                          (qd, do)) == nb(lse)
    dargs = (qd, kd, vd, do, lse, lse)
    assert dryrun.peak_of(lambda: fa.flash_bwd_dkdv_cuda(
        *dargs, window=window), dargs) == nb(kd, vd)
    assert dryrun.peak_of(lambda: fa.flash_bwd_dq_cuda(
        *dargs, window=window), dargs) == nb(qd)


def test_flash_pairs_off_the_diagonal():
    for sq, sk, causal, window in ((64, 150, False, 0), (130, 70, True, 0),
                                   (200, 200, True, 64), (5, 9, True, 3)):
        i, j = np.arange(sq)[:, None], np.arange(sk)[None]
        keep = np.ones((sq, sk), bool)
        if causal:
            keep &= j <= i
        if window:
            keep &= j > i - window
        assert costs.flash_pairs(sq, sk, causal, window) == keep.sum()


def test_meta_decode():
    bh, bh_kv, S, hd = 8, 4, 1000, 128
    q, k, v = meta(bh, 1, hd, dtype=BF), *(meta(bh_kv, S, hd, dtype=BF)
                                           for _ in range(2))
    lengths = meta(bh, dtype=torch.int32)
    out, calls = recorded(lambda: ops.decode_attention(q, k, v, lengths))
    assert (tuple(out.shape), out.dtype) == ((bh, 1, hd), BF)
    assert calls == [("decode_attention",
                      *costs.decode(bh, bh_kv, hd, BF, bh * S, bh_kv * S))]
    _, splits = da.plan_splits(S)
    assert dryrun.peak_of(lambda: ops.decode_attention(q, k, v, lengths),
                          (q, k, v, lengths)) == \
        nb(q, meta(bh, splits, hd + 2))


def test_meta_decode_lse():
    """The log-sum-exp route on meta: the output in f32 and the lse (BH,)
    f32, allocated with the partials, and the route's bytes recorded (o
    written in f32, the lse too)."""
    bh, bh_kv, S, hd = 8, 4, 1000, 128
    q, k, v = meta(bh, 1, hd, dtype=BF), *(meta(bh_kv, S, hd, dtype=BF)
                                           for _ in range(2))
    lengths = meta(bh, dtype=torch.int32)

    def call():
        return da.decode_attention_cuda(q, k, v, lengths, with_lse=True)
    (out, lse), calls = recorded(call)
    assert (tuple(out.shape), out.dtype) == ((bh, 1, hd), F32)
    assert (tuple(lse.shape), lse.dtype) == ((bh,), F32)
    cost = costs.decode(bh, bh_kv, hd, BF, bh * S, bh_kv * S, lse=True)
    assert calls == [("decode_attention", *cost)]
    assert cost[0] == costs.decode(bh, bh_kv, hd, BF, bh * S,
                                   bh_kv * S)[0] + bh * hd * 2 + bh * 4
    _, splits = da.plan_splits(S)
    assert dryrun.peak_of(call, (q, k, v, lengths)) == \
        nb(meta(bh, 1, hd), meta(bh), meta(bh, splits, hd + 2))


def test_meta_ssm_scan():
    bh, bh_bc, s, hd, ds, chunk = 8, 2, 300, 64, 64, 128
    xbar, cum = meta(bh, s, hd, grad=True), meta(bh, s, grad=True)
    B, C = (meta(bh_bc, s, ds, dtype=BF, grad=True) for _ in range(2))
    (y, h), calls = recorded(lambda: ops.ssm_scan(xbar, B, C, cum,
                                                  chunk=chunk))
    assert [(tuple(t.shape), t.dtype) for t in (y, h)] == \
        [((bh, s, hd), F32), ((bh, hd, ds), F32)]
    check_saved(y, [((bh, s, hd), F32), ((bh_bc, s, ds), BF),
                    ((bh_bc, s, ds), BF), ((bh, s), F32)])
    assert calls == [("ssm_scan", *costs.ssm(bh, bh_bc, s, hd, ds, chunk,
                                              BF))]
    dy, dh = meta(bh, s, hd), meta(bh, hd, ds)
    grads, calls = recorded(lambda: torch.autograd.grad(
        (y, h), (xbar, B, C, cum), (dy, dh)))
    assert [g.shape for g in grads] == [xbar.shape, B.shape, C.shape,
                                        cum.shape]
    assert grads[1].dtype == BF
    assert calls == [("ssm_scan_bwd", *costs.ssm_bwd(bh, bh_bc, s, hd, ds,
                                                      chunk, BF))]
    ins = tuple(t.detach() for t in (xbar, B, C, cum))
    assert dryrun.peak_of(lambda: ss.ssm_scan_cuda(*ins, chunk=chunk), ins) \
        == nb(ins[0], meta(bh, hd, ds))
    states = meta(ss.bwd_scratch_floats(bh, bh_bc, s, hd, ds, chunk))
    assert dryrun.peak_of(
        lambda: ss.ssm_scan_bwd_cuda(*ins, dy, dh, chunk=chunk),
        ins + (dy, dh)) == nb(*ins, states, meta(2, bh, s, ds))


@pytest.mark.parametrize("dtype", [F32, BF])
def test_meta_rwkv6_scan(dtype):
    bh, nu, s, hd = 8, 4, 200, 64
    r, k, v, w = (meta(bh, s, hd, dtype=dtype, grad=True) for _ in range(4))
    u = meta(nu, hd, grad=True)
    (o, st), calls = recorded(lambda: ops.rwkv6_scan(r, k, v, w, u))
    assert [(tuple(t.shape), t.dtype) for t in (o, st)] == \
        [((bh, s, hd), dtype), ((bh, hd, hd), F32)]
    check_saved(o, [((bh, s, hd), dtype)] * 4 + [((nu, hd), F32)])
    assert calls == [("rwkv6_scan", *costs.rwkv(bh, nu, s, hd, dtype,
                                                 rs.CHUNK))]
    do, dst = meta(bh, s, hd, dtype=dtype), meta(bh, hd, hd)
    grads, calls = recorded(lambda: torch.autograd.grad(
        (o, st), (r, k, v, w, u), (do, dst)))
    assert [g.shape for g in grads] == [r.shape] * 4 + [u.shape]
    assert calls == [("rwkv6_scan_bwd", *costs.rwkv_bwd(bh, nu, s, hd,
                                                         dtype))]
    ins = tuple(t.detach() for t in (r, k, v, w, u))
    nc, nrb = -(-s // rs.BWD_CHUNK), hd // rs.bwd_rows(hd)
    work = (meta(bh * nc * (2 * hd * hd + hd + rs.BWD_CHUNK)),
            meta(bh, nrb, s, hd), meta(nc, bh, hd))
    assert dryrun.peak_of(lambda: rs.rwkv6_scan_bwd_cuda(*ins, do, dst),
                          ins + (do, dst)) == nb(*ins, *work)


def test_meta_route_launches_nothing_and_cpu_stays_plain():
    ops.reset_launch_counts()
    x, w = meta(4, 64, dtype=BF), meta(64)
    ops.fused_rmsnorm(x, w)
    assert all(v == 0 for v in ops.launch_counts().values())
    xc = torch.randn(4, 64)
    wc = torch.randn(64)
    with costs.recording() as calls:
        out = ops.fused_rmsnorm(xc, wc)
    assert calls == [] and out.device.type == "cpu"
    torch.testing.assert_close(out, rn.fused_rmsnorm_plain(xc, wc), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._on_card(SimpleNamespace(device=torch.device("xpu")), "x")


class CudaStub:
    """A meta tensor that reports itself on cuda:0, for checks that run
    before any pointer is used: a stand-in for a card tensor here."""
    device, is_meta, is_cuda, requires_grad = (torch.device("cuda", 0),
                                               False, True, False)

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def mixed_calls():
    n, d, bh, bh_kv, s, hd, ds = 4, 64, 4, 2, 32, 64, 64
    q, k, v = (meta(b, s, hd, dtype=BF) for b in (bh, bh_kv, bh_kv))
    lse = meta(bh, s)
    x = meta(bh, s, hd)
    B, C = meta(2, s, ds, dtype=BF), meta(2, s, ds, dtype=BF)
    rk = [meta(bh, s, hd) for _ in range(4)]
    return {
        "fused_rmsnorm": (rn.fused_rmsnorm_cuda,
                          (meta(n, d, dtype=BF), meta(d)), {}),
        "fused_rmsnorm_bwd": (rn.fused_rmsnorm_bwd_cuda,
                              (meta(n, d, dtype=BF), meta(d),
                               meta(n, d, dtype=BF)), {}),
        "flash_attention": (fa.flash_attention_cuda, (q, k, v), {}),
        "flash_bwd_preprocess": (fa.flash_bwd_preprocess_cuda,
                                 (q, meta(bh, s, hd, dtype=BF)), {}),
        "flash_bwd_dkdv": (fa.flash_bwd_dkdv_cuda, (q, k, v, q, lse, lse),
                           {}),
        "flash_bwd_dq": (fa.flash_bwd_dq_cuda, (q, k, v, q, lse, lse), {}),
        "decode_attention": (da.decode_attention_cuda,
                             (meta(bh, 1, hd, dtype=BF), k, v,
                              meta(bh, dtype=torch.int32)), {}),
        "ssm_scan": (ss.ssm_scan_cuda, (x, B, C, meta(bh, s)),
                     {"chunk": 16}),
        "ssm_scan_bwd": (ss.ssm_scan_bwd_cuda,
                         (x, B, C, meta(bh, s), x, meta(bh, hd, ds)),
                         {"chunk": 16}),
        "rwkv6_scan": (rs.rwkv6_scan_cuda, (*rk, meta(bh, hd)), {}),
        "rwkv6_scan_bwd": (rs.rwkv6_scan_bwd_cuda,
                           (*rk, meta(bh, hd), rk[0], meta(bh, hd, hd)),
                           {}),
    }


MIXED = [(name, i) for name, (_, args, _) in mixed_calls().items()
         for i in range(len(args))]


@pytest.mark.parametrize("name,i", MIXED)
def test_wrappers_refuse_inputs_on_two_devices(name, i, monkeypatch):
    """Every input of a kernel wrapper lies on one device: a meta input
    beside card inputs (a null pointer in a launch), or a card input
    beside meta ones (a skipped launch), raises before anything runs."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    fn, args, kw = mixed_calls()[name]
    args = list(args)
    args[i] = CudaStub(args[i])
    ops.reset_launch_counts()
    with costs.recording() as calls, \
            pytest.raises(ValueError, match="not on (meta|cuda:0) as the"):
        fn(*args, **kw)
    assert calls == [] and all(v == 0 for v in ops.launch_counts().values())


def test_train_step_gives_an_unreached_embedding_a_zero_gradient():
    """musicgen's untied token embedding takes no part in a loss whose
    ``embeds`` replace the tokens: it gets JAX's zero gradient, and the
    AdamW step (which raised on the missing gradient) runs, on the CPU as
    in the dry run."""
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.params import init_params
    from repro_torch.training import init_opt_state, make_train_step
    cfg = get_smoke("musicgen-large")
    params = init_params(cfg, seed=0, device="cpu", dtype=F32)
    lm = LM.from_params(cfg, params)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"tokens": tokens, "targets": tokens,
             "embeds": torch.randn(2, 16, cfg.d_model, generator=gen)}
    step = make_train_step(lm, TrainConfig(microbatches=2))
    opt, metrics = step(init_opt_state(params), batch)
    embed = dict(lm.named_parameters())["embed"]
    assert torch.equal(embed.grad, torch.zeros_like(embed))
    assert bool(torch.isfinite(metrics["loss"])) and opt["step"] == 1
    res = dryrun.run_cell("musicgen-large", "train_4k", layers=1, batch=1)
    assert res["status"] == "ok" and res["fits"] is True
