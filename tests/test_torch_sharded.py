"""The port's sharded step (DTensor parameters and caches, ``shard`` at
JAX's constraint points, the kernels on local shards) on four CPU ranks
of ``gloo`` against the unsharded port, JAX's model and the dry run.

The deepseek-7b smoke runs on a (1, 4) mesh (``quad``'s layout: heads,
MLP and vocabulary split four ways) and the deepseek-67b smoke on a
(2, 2) mesh (its 2 KV heads over the model axis; the batch and the
FSDP dim ``embed_w`` over the data axis, which ``quad`` never splits).
The deepseek-67b smoke's d_model is widened from 96 to 128, in both
packages: its head dim (12) is none the kernels take, and the dry run,
whose collectives the test holds, runs the kernels' meta route, which
checks it; at 128 it is 16.
The MoE stacks: the moonshot-v1-16b-a3b smoke on (1, 4) (4 heads and 4
KV heads, 8 experts, the dense head layer's MLP, each split four ways)
and the granite-moe-3b-a800m smoke on (2, 2) (6 heads over 2 KV heads,
4 experts over 2, the batch on the data axis, and the expert weights'
and the dispatch buffer's d on the data axis, JAX's layout, before the
contraction reduces it; its tied head). Both smokes are dropless
(capacity factor 8.0), so a third case runs the moonshot smoke at 1.0,
where prefill drops assignments (the sentinel slot under sharding).
gemma3's rings and the scans on their heads: the gemma3-12b smoke on
(1, 4) at d 128 over 8 heads and 4 KV heads (hd 16; its 2 KV heads do
not divide the model axis), the gemma3-27b smoke on (2, 2) at window 12
(a 16-token prompt wraps its rings), the zamba2-1.2b smoke on (1, 4) at
ssm head dim 16 (8 heads, 2 a rank) and the rwkv6-1.6b smoke on (2, 2)
at head dim 16 (4 heads, 2 a rank), each field changed in both
packages. The frontend archs, both smokes unchanged on (1, 4): qwen2-vl-2b
(4 heads over 2 KV heads, M-RoPE), whose KV heads do not divide the
model axis, so the cache's sequence is split (MAX_LEN 20: 5 slots a
rank, the 16-token prompt ending inside rank 3's slice), k and v are
gathered whole for flash (each rank's query head over its own KV head)
and decode runs on each rank's slice, the ranks' partial softmax states
merged (the M-RoPE streams, like every activation, keep their sequence
whole on each rank); musicgen-large, whose untied token embedding the
loss then does not reach: it takes a zero gradient, a DTensor at its
placements. Both are fed their frontend's embeddings made from the
unsharded weights (``input_embeds_for``: qwen2-vl's vision patches then
its text, musicgen's codebooks; the same (B, S, d) array in both
packages), placed as the dry run places them. The four ranks come from one
``mp.spawn`` for each family
group (SPAWNS), joined by a ``FileStore`` under ``tmp_path`` (no port to
contend for), and each spawn must end within ``SPAWN_LIMIT_S``. JAX runs
only in the test process.

Tolerances:
* prefill logits, one decode step's logits, the train step's loss and
  the AdamW update against the unsharded port, both in f32: 2e-5 (the
  same f32 ops; the sharded sums are split and reduced in another order);
* each gradient leaf (``full_tensor``): max |sharded - unsharded| / max
  |unsharded| within 2e-5 (GRAD_TOL). A leaf beyond it must stay within
  GAP_CEILING (1e-4) and within the leaf's rounding floor: every f32
  weight of the unsharded port nudged one ulp up or down at random, its
  gradients computed again, the leaf's max |nudged - unnudged| / max |g|
  over FLOOR_DRAWS draws (as test_torch_family_grads.py measures it). So
  the sharded step moves no gradient more than one ulp of the weights
  moves the unsharded one. On the CPU, 14 leaves of the deepseek-67b
  smoke (layer 0, the embedding and layer 1's attention) sit between
  3.6e-5 and 7.8e-5 with floors of 2.3e-4 to 5.5e-4 (the heads' partial
  products summed in another order, amplified through the backward);
  ``pytest -s -k train_step`` prints each leaf's gap and floor. The MoE
  cases hold their gradients so in an f64 train step (matmul weights
  and compute in f64; norms, embeddings and the CE head stay f32, as
  everywhere in the port): the experts' activations are rounded to
  bf16 (JAX's ``layers.py:399-401``), which turns the f32 ulps of the
  split sums into a bf16 ulp of an activation wherever one lies near a
  rounding edge. In f32 the sharded gradients then sit at the leaves'
  f32 floors (both up to ~2.2e-3; the gap over the floor at most 1.20
  on the CPU), above GAP_CEILING; in f64 within 2.7e-6. So each f32
  leaf of the MoE cases is held, beside the f64 check, within
  max(GRAD_TOL, F32_FLOOR_MARGIN x its f32 floor), F32_FLOOR_MARGIN 2:
  the floor is the largest of FLOOR_DRAWS random nudges, and the split
  sums' rounding is one more such draw; a wrong gradient (a partial sum
  reduced twice or not at all, a cast) moves a leaf by far more. Their
  loss and update are held in f32;
* the sharded prefill logits against JAX's in f32 compute: 2e-3, the
  model tolerance of test_torch_models.py;
* rank 0's collectives, by kind, equal in count to those the dry run
  reckons for the same steps, in the same f32 compute, on the meta
  device under the fake group (DTensor picks how to reduce by bytes, so
  the dtype can change the plan: a bf16 decode step on the (2, 2) mesh
  reduces with all-reduces where f32 takes reduce-scatters); in the MoE
  cases neither gathers an expert output, and on (1, 4) each MoE layer
  of the decode step reduces y with one all-reduce of y's shape.
* gemma3's and the scan stacks' gradients are held as the MoE cases'
  (GRAD_DTYPE f64, f32 within F32_FLOOR_MARGIN x the floor): random
  gemma3 and zamba2 weights amplify the split sums' f32 rounding too.
  zamba2's logits likewise (LOGITS_DTYPE): its f32 prefill and decode
  logits sit at their one-ulp floor (max |nudged - unnudged| over the
  FLOOR_DRAWS draws; on the CPU prefill 1.7e-4 against 2.8e-4, decode
  7.4e-5 against 1.4e-4), so prefill and decode run again in f64, held
  within 2e-5, and the f32 logits within F32_FLOOR_MARGIN x that floor;
  JAX's f32 logits are held against the f32 ones.
* the frontend archs' gradients are held in f32 by the first rule: no
  leaf sits at its floor (on the CPU qwen2-vl's largest gap is 2.3e-5,
  layer 0's ``w_down`` at a floor of 5.7e-5; musicgen's 9.8e-6), and
  musicgen's token embedding, which the loss does not reach, is zero in
  both.
"""
import functools
import os
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.distributed.sharding import (named_sharding,  # noqa: E402
                                              use_mesh)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import device_mesh, make_mesh  # noqa: E402
from repro_torch.models import LM, layers  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402
from repro_torch.training.optimizer import (adamw_update,  # noqa: E402
                                            init_opt_state, leaf_order,
                                            loss_and_grads)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5
GAP_CEILING = 1e-4
FLOOR_DRAWS = 4
#: an f32 MoE gradient leaf's gap may reach this many times its floor
F32_FLOOR_MARGIN = 2
JAX_TOL = dict(rtol=2e-3, atol=2e-3)        # test_models.py:61
RANKS = 4
SPAWN_LIMIT_S = 240
MOONSHOT, GRANITE = "moonshot-v1-16b-a3b", "granite-moe-3b-a800m"
GEMMA12, GEMMA27 = "gemma3-12b", "gemma3-27b"
ZAMBA, RWKV = "zamba2-1.2b", "rwkv6-1.6b"
QWEN, MUSICGEN = "qwen2-vl-2b", "musicgen-large"
#: case -> (arch, (data, model) mesh, the smoke's fields changed: module
#: docstring)
CASES = {"deepseek-7b": ("deepseek-7b", (1, 4), {}),
         "deepseek-67b": ("deepseek-67b", (2, 2), {"d_model": 128}),
         MOONSHOT: (MOONSHOT, (1, 4), {}),
         GRANITE: (GRANITE, (2, 2), {}),
         f"{MOONSHOT}-cf1": (MOONSHOT, (1, 4), {"capacity_factor": 1.0}),
         GEMMA12: (GEMMA12, (1, 4), {"d_model": 128, "n_heads": 8,
                                     "n_kv_heads": 4}),
         GEMMA27: (GEMMA27, (2, 2), {"local_window": 12}),
         ZAMBA: (ZAMBA, (1, 4), {"ssm_head_dim": 16}),
         RWKV: (RWKV, (2, 2), {"rwkv_head_dim": 16}),
         QWEN: (QWEN, (1, 4), {}),
         MUSICGEN: (MUSICGEN, (1, 4), {})}
MOE = [c for c, (a, _, _) in CASES.items() if a in (MOONSHOT, GRANITE)]
#: the cases of each spawn of four ranks, by family: the uniform stacks,
#: then gemma3's rings and the scans, then the frontend archs
SPAWNS = (("deepseek-7b", "deepseek-67b", *MOE),
          (GEMMA12, GEMMA27, ZAMBA, RWKV), (QWEN, MUSICGEN))
B, S, MAX_LEN = 4, 16, 20
TCFG = TrainConfig(microbatches=1)
F32, F64 = torch.float32, torch.float64
#: case -> the dtype its gradients are held in (module docstring)
GRAD_DTYPE = {c: F64 for c in MOE + [GEMMA12, GEMMA27, ZAMBA, RWKV]}
#: case -> the dtype its prefill and decode logits are held in (module
#: docstring)
LOGITS_DTYPE = {ZAMBA: F64}
#: the scan cases also run their layer 0 over CARRIED_S tokens from a
#: carried state (``ssm_block(h=)``, ``rwkv_block(state)``) in f64
CARRIED = (ZAMBA, RWKV)
CARRIED_S = 12


def _config(case, get=get_smoke):
    """The case's smoke config (the JAX package's with ``get``)."""
    arch, _, fields = CASES[case]
    return get(arch).with_(**fields)


def _inputs(cfg, tree):
    """Tokens, targets and the decode step's token; for a vision or audio
    arch the frontend's embeddings of the prompt (B, S, d) as f32 numpy,
    made from the unsharded token embedding of ``tree`` (the vision
    patches bf16 values, drawn from a generator seeded with 0), which the
    dry run feeds such an arch in place of the prompt's tokens."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
           "targets": rng.integers(0, cfg.vocab, (B, S)),
           "next": rng.integers(0, cfg.vocab, (B,))}
    if cfg.modality != "text":
        from repro_torch.models.frontends import input_embeds_for
        table = torch.from_numpy(np.array(tree["embed"], np.float32))
        out["embeds"] = input_embeds_for(
            cfg, {"embed": table}, torch.from_numpy(out["tokens"])) \
            .float().numpy()
    return out


def _embeds(inputs, place):
    """The inputs' frontend embeddings placed as the dry run places them
    (``("batch", "seq", None)``), or None."""
    if "embeds" not in inputs:
        return None
    return place(torch.from_numpy(inputs["embeds"]), ("batch", "seq", None))


def _serve(cfg, params, inputs, place, counted, dtype=F32):
    """Prefill and one decode step of the port in ``dtype`` on
    ``params``, each in its ``counted`` context; the logits read whole."""
    out = {}
    lm = LM.from_params(cfg, params, dtype=dtype)
    tokens = place(torch.from_numpy(inputs["tokens"]), ("batch", "seq"))
    embeds = _embeds(inputs, place)
    with torch.no_grad():
        with counted("prefill"):
            logits, cache = lm.prefill(tokens, MAX_LEN, embeds=embeds)
        out["prefill"] = place.full(logits)
        token = place(torch.from_numpy(inputs["next"]), ("batch",))
        pos = place(torch.full((B,), S, dtype=torch.int64), ("batch",))
        with counted("decode"):
            logits, cache = lm.decode_step(token, cache, pos)
        out["decode"] = place.full(logits)
    return out


def _steps(cfg, tree, inputs, place, counted, grad_dtype=F32,
           logits_dtype=F32):
    """Prefill, one decode step and one train step of the f32 port on the
    parameters ``tree`` (JAX's numpy tree); ``place(t, axes)`` lays an
    input out, ``counted(name)`` is the context each step runs in, and
    ``full(t)`` reads a result whole (outside the counted steps). With
    ``grad_dtype`` f64 the gradients held are those of a second,
    uncounted train step in f64 (the f32 ones kept as ``grads_f32``);
    with ``logits_dtype`` f64 so are the prefill and decode logits (the
    f32 ones kept as ``prefill_f32`` and ``decode_f32``)."""
    import contextlib
    ctx_params = dict(dtype=F32)
    out = _serve(cfg, place.params(tree, cfg), inputs, place, counted)
    if logits_dtype != F32:
        out.update({f"{k}_f32": v for k, v in out.items()})
        out.update(_serve(cfg, place.params(tree, cfg, logits_dtype), inputs,
                          place, lambda name: contextlib.nullcontext(),
                          logits_dtype))
    lm = LM.from_params(cfg, place.params(tree, cfg), **ctx_params)
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    batch = {k: place(torch.from_numpy(inputs[k]), ("batch", "seq"))
             for k in ("tokens", "targets")}
    if "embeds" in inputs:
        batch["embeds"] = _embeds(inputs, place)
    opt = init_opt_state(params)
    with counted("train"):
        loss, grads = loss_and_grads(lm, batch, TCFG, TCFG.remat != "none")
    out["loss"] = place.full(loss)
    out["grads"] = {n: place.full(g) for n, g in grads.items()}
    # each gradient at its parameter's placements (a plain tensor: None)
    out["grad_placements"] = {
        n: (tuple(g.placements) == tuple(params[n].placements)
            if hasattr(g, "placements") else None)
        for n, g in grads.items()}
    with counted("train"):
        adamw_update(params, grads, opt, TCFG, leaf_order(params, cfg))
    out["update"] = {n: place.full(p.detach()) for n, p in params.items()}
    if grad_dtype != F32:
        out["grads_f32"] = out["grads"]
        lm = LM.from_params(cfg, place.params(tree, cfg, grad_dtype),
                            dtype=grad_dtype)
        for p in lm.parameters():
            p.requires_grad_(True)
        _, grads = loss_and_grads(lm, batch, TCFG, TCFG.remat != "none")
        out["grads"] = {n: place.full(g) for n, g in grads.items()}
    return out


def _carried(cfg, tree, place):
    """Layer 0 of the case's f64 port over CARRIED_S tokens from a random
    carried state placed at its cache's spec (heads whole): the output,
    the final state and the gradients of a fixed projection of both with
    respect to x, the carried state and the weight whose projection reads
    it (zamba's w_C, rwkv's w_r), read whole."""
    from repro_torch.models import rwkv, ssm
    rng = np.random.default_rng(11)

    def draw(shape, axes, scale=1.0):
        return place(torch.from_numpy(rng.standard_normal(shape) * scale),
                     axes)
    lm = LM.from_params(cfg, place.params(tree, cfg, F64), dtype=F64)
    layer = lm.layers[0]
    x = draw((B, CARRIED_S, cfg.d_model), ("batch", "seq", None))
    heads = ("batch", None, None, None)
    if lm.kind == "zamba":
        _, nh, hd, ds = ssm.ssm_dims(cfg)
        s0, w = draw((B, nh, hd, ds), heads, 0.5), layer.w_C
    else:
        nh, hd = rwkv.rwkv_dims(cfg)
        s0, w = draw((B, nh, hd, hd), heads, 0.5), layer.w_r
        rows = {k: draw((B, cfg.d_model), ("batch", None))
                for k in ("x_tm", "x_cm")}
    for t in (x, s0, w):
        t.requires_grad_(True)
    if lm.kind == "zamba":
        out, last = ssm.ssm_block(layer, x, cfg, h=s0)
    else:
        out, new = rwkv.rwkv_block(layer, x, cfg, {**rows, "S": s0})
        last = new["S"]
    full = [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in (out, last)]
    ro, rl = (torch.from_numpy(rng.standard_normal(t.shape)) for t in full)
    loss = (full[0] * ro).sum() + (full[1] * rl).sum()
    grads = torch.autograd.grad(loss, (x, s0, w))
    return {"out": place.full(out), "state": place.full(last),
            "grads": [place.full(g) for g in grads]}


class _Plain:
    """Inputs and parameters as plain tensors: the unsharded port."""

    def __call__(self, t, axes):
        return t

    @staticmethod
    def params(tree, cfg, dtype=F32):
        return from_jax_numpy(tree, cfg, "cpu", dtype)

    @staticmethod
    def full(t):
        return t.detach().clone()


class _Sharded:
    """Inputs cut to their resolved placements, parameters as DTensors
    (``from_jax_numpy``'s sharded form), results gathered whole."""

    def __init__(self, ctx):
        self.ctx = ctx

    def __call__(self, t, axes):
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = named_sharding(t.shape, axes, self.ctx)
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    def params(self, tree, cfg, dtype=F32):
        return from_jax_numpy(tree, cfg, "cpu", dtype, ctx=self.ctx)

    @staticmethod
    def full(t):
        return t.detach().full_tensor().clone()


def _rank(rank, store_path, out_dir, jobs):
    import contextlib

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, RANKS), rank=rank,
        world_size=RANKS)
    try:
        for case, tree in jobs:
            cfg = _config(case)
            mesh = make_mesh(*CASES[case][1], [torch.device("cpu")] * RANKS)
            counts: dict = {}
            log: list = []

            @contextlib.contextmanager
            def counted(name):
                counter = dryrun.CollectiveCounter()
                with counter:
                    yield
                got = counts.setdefault(name, {})
                for kind, c in counter.collectives.items():
                    got[kind] = got.get(kind, 0) + c["count"]
                log.extend(counter.log)

            with use_mesh(mesh, device_mesh=device_mesh(mesh, "cpu")) as ctx:
                out = _steps(cfg, tree, _inputs(cfg, tree), _Sharded(ctx),
                             counted,
                             GRAD_DTYPE.get(case, F32),
                             LOGITS_DTYPE.get(case, F32))
                if case in CARRIED:
                    out["carried"] = _carried(cfg, tree, _Sharded(ctx))
            out["collectives"], out["collective_log"] = counts, log
            if rank == 0:
                with open(os.path.join(out_dir, f"{case}.pkl"), "wb") as f:
                    pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's parameter trees (PRNGKey 0) and f32 prefill logits."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.distributed import materialize
    from repro.models import LM as JaxLM
    from repro.models import layers as jl
    from repro.models import model_specs
    out = {}
    for case in CASES:
        jcfg = _config(case, jax_get_smoke)
        params = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        jl.set_compute_dtype(jnp.float32)
        inputs = _inputs(_config(case), tree)
        try:
            logits, _ = JaxLM(jcfg).prefill(
                params, jnp.asarray(inputs["tokens"]), max_len=MAX_LEN,
                embeds=(jnp.asarray(inputs["embeds"]) if "embeds" in inputs
                        else None))
        finally:
            jl.set_compute_dtype(jnp.bfloat16)
        out[case] = (tree, np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def sharded(jax_side, tmp_path_factory):
    """Rank 0's results of the four-rank runs, by case: one spawn for each
    group of SPAWNS, each within SPAWN_LIMIT_S."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("sharded")
    for i, group in enumerate(SPAWNS):
        jobs = [(c, jax_side[c][0]) for c in group]
        ctx = mp.start_processes(
            _rank, args=(str(tmp / f"store{i}"), str(tmp), jobs),
            nprocs=RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_LIMIT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    pytest.fail(f"the {RANKS} ranks of {group} did not end "
                                f"within {SPAWN_LIMIT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    out = {}
    for case in CASES:
        with open(tmp / f"{case}.pkl", "rb") as f:
            out[case] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def plain(jax_side):
    """The unsharded port's results, by case, with each gradient leaf's
    rounding floor (``floor``, and ``floor_f32`` where the gradients are
    held in f64: see the module docstring)."""
    import contextlib
    out = {}
    for a in CASES:
        cfg, tree = _config(a), jax_side[a][0]

        def run(tr):
            return _steps(cfg, tr, _inputs(cfg, tree), _Plain(),
                          lambda name: contextlib.nullcontext(),
                          GRAD_DTYPE.get(a, F32), LOGITS_DTYPE.get(a, F32))
        out[a] = run(tree)
        rng = np.random.default_rng(1)
        keys = [k for k in ("grads", "grads_f32") if k in out[a]]
        floors: dict = {k: {} for k in keys}
        floor_logits: dict = {}
        for _ in range(FLOOR_DRAWS):
            nudged = _map(lambda x: np.nextafter(x, np.where(
                rng.random(x.shape) < 0.5, -np.inf, np.inf).astype(x.dtype))
                if x.dtype == np.float32 else x, tree)
            moved = run(nudged)
            for k in ("prefill_f32", "decode_f32"):
                if k in moved:
                    floor_logits[k] = max(floor_logits.get(k, 0.0), float(
                        (moved[k] - out[a][k]).abs().max()))
            for k in keys:
                for n, g in out[a][k].items():
                    rel = _gap(moved[k][n], g)
                    floors[k][n] = max(floors[k].get(n, 0.0), rel)
        out[a]["floor"] = floors["grads"]
        if "grads_f32" in floors:
            out[a]["floor_f32"] = floors["grads_f32"]
        if a in LOGITS_DTYPE:
            out[a]["floor_logits"] = floor_logits
    return out


def _map(fn, tree):
    return ({k: _map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _close(a, b, **tol):
    np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


def _close_logits(case, step, sharded, plain):
    """The step's logits within TOL of the unsharded port's; for a case of
    LOGITS_DTYPE those in f64, and the f32 ones within F32_FLOOR_MARGIN x
    their rounding floor (module docstring). Returns the f32 logits."""
    got, want = sharded[case], plain[case]
    _close(got[step], want[step], **TOL)
    if f"{step}_f32" not in want:
        return got[step]
    f32, floor = got[f"{step}_f32"], want["floor_logits"][f"{step}_f32"]
    gap = float((f32 - want[f"{step}_f32"]).abs().max())
    print(f"{case} {step} in f32: gap {gap:.3e}, floor {floor:.3e}")
    assert gap <= max(TOL["atol"], F32_FLOOR_MARGIN * floor), (gap, floor)
    return f32


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_matches_unsharded_and_jax(case, sharded, plain, jax_side):
    out = _close_logits(case, "prefill", sharded, plain)
    assert out.shape == (B, 1, _config(case).vocab)
    np.testing.assert_allclose(out.numpy(), jax_side[case][1], **JAX_TOL)


@pytest.mark.parametrize("case", CARRIED)
def test_block_from_a_carried_state_matches_unsharded(case, sharded,
                                                      jax_side):
    """zamba2's ssm_block(h=) and rwkv6's rwkv_block(state) of several
    tokens on the ranks' heads, the carried state placed at its cache's
    spec and split as the scan's final state: output, final state and the
    gradients (x, the state, the weight that reads it) within TOL of the
    unsharded port's, in f64."""
    got = sharded[case]["carried"]
    want = _carried(_config(case), jax_side[case][0], _Plain())
    _close(got["out"], want["out"], **TOL)
    _close(got["state"], want["state"], **TOL)
    for g, w in zip(got["grads"], want["grads"], strict=True):
        assert _gap(g, w) <= GRAD_TOL, _gap(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_unsharded(case, sharded, plain):
    _close_logits(case, "decode", sharded, plain)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_unsharded(case, sharded, plain):
    got, want = sharded[case], plain[case]
    _close(got["loss"], want["loss"], **TOL)
    assert set(got["grads"]) == set(want["grads"])
    floor = want["floor"]
    bad = {}
    placed = got["grad_placements"]
    assert set(placed.values()) == {True}, placed
    for n, g in want["grads"].items():
        scale = float(g.abs().max())
        if n == "embed" and CASES[case][0] == MUSICGEN:
            # the frontend's embeddings replace the tokens: the loss does
            # not reach the token embedding, whose gradient is zero in
            # both (a DTensor at its placements under sharding)
            assert scale == 0 and not got["grads"][n].any(), n
            continue
        assert scale > 0, n
        rel = float((got["grads"][n] - g).abs().max()) / scale
        f32 = ""
        if "grads_f32" in want:
            gap = _gap(got["grads_f32"][n], want["grads_f32"][n])
            f32_floor = want["floor_f32"][n]
            f32 = f"; in f32 {gap:.3e}, floor {f32_floor:.3e}"
            if gap > max(GRAD_TOL, F32_FLOOR_MARGIN * f32_floor):
                bad[f"{n} (f32)"] = (gap, f32_floor)
        print(f"{case} {n}: gap {rel:.3e}, floor {floor[n]:.3e}{f32}")
        if rel > GRAD_TOL and not rel <= min(GAP_CEILING, floor[n]):
            bad[n] = (rel, floor[n])
    assert not bad, bad
    for n in want["update"]:
        _close(got["update"][n], want["update"][n], **TOL)


@functools.lru_cache(maxsize=None)
def _dry_steps(case):
    """The fake-group dry run of the three steps of ``case`` (once)."""
    cfg = _config(case)
    with dryrun.sharded_step(make_mesh(*CASES[case][1])):
        return {"prefill": dryrun.trace_prefill(cfg, B, S, F32),
                "decode": dryrun.trace_decode(cfg, B, MAX_LEN, F32),
                "train": dryrun.trace_train(cfg, B, S, TCFG.microbatches,
                                            dtype=F32)}


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_match_the_dry_run(case, sharded):
    """Rank 0's collectives by kind against the fake-group dry run of the
    same three steps at the same shapes (meta DTensors, the kernels'
    meta route in place of the plain versions)."""
    got = sharded[case]["collectives"]
    for step, res in _dry_steps(case).items():
        counts = {k: c["count"] for k, c in res["collectives"].items()}
        assert counts, f"{step}: the dry run reckons no collective"
        assert got[step] == counts, step


def _expert_output_gathers(case, log):
    """The all-gathers in ``log`` whose operand is a shard of an expert
    output (B, E, C, d): 4-D, C slots an expert, d or a part of it
    last (the activations' last dim is d_ff, which differs)."""
    cfg = _config(case)
    caps = {layers.capacity(cfg, n) for n in (S, 1)}
    assert cfg.d_ff not in {cfg.d_model // k for k in (1, 2, 4)}
    return [(kind, shape) for kind, shape in log
            if kind == "all-gather" and len(shape) == 4
            and shape[2] in caps
            and shape[3] in {cfg.d_model // k for k in (1, 2, 4)}]


@pytest.mark.parametrize("case", MOE)
def test_no_collective_gathers_the_expert_output(case, sharded):
    """The combine sums each rank's experts into a partial y, which is
    reduced: rank 0 and the dry run gather no expert output (DTensor's
    own reshape of a yexp split on its experts would all-gather it), and
    one all-reduce a MoE layer of the decode step moves y's bytes."""
    assert sharded[case]["collective_log"], case
    assert not _expert_output_gathers(case, sharded[case]["collective_log"])
    dry = _dry_steps(case)
    for step, res in dry.items():
        assert not _expert_output_gathers(case, res["collective_log"]), step
    cfg = _config(case)
    if CASES[case][1] == (1, 4):
        # quad's layout: the decode step's only collectives are the
        # embedding's and two a layer (attention's out, then the dense
        # MLP's or the MoE's y), each an all-reduce of y's shape
        assert dry["decode"]["collective_log"] == \
            [("all-reduce", (B, 1, cfg.d_model))] * (2 * cfg.n_layers + 1)


def test_capacity_case_drops_assignments(jax_side):
    """The port-against-port case at capacity factor 1.0 drops
    assignments in prefill (slot E * C), so the sentinel slot is held
    under sharding; the dropless smokes drop none."""
    for case, dropped in ((f"{MOONSHOT}-cf1", True), (MOONSHOT, False)):
        cfg = _config(case)
        lm = LM.from_params(cfg, from_jax_numpy(jax_side[case][0], cfg,
                                                "cpu", F32), dtype=F32)
        mods = [b.moe for b in lm.layers if hasattr(b, "moe")]
        for m in mods:
            m.routes = []
        with torch.no_grad():
            lm.prefill(torch.from_numpy(
                _inputs(cfg, jax_side[case][0])["tokens"]), MAX_LEN)
        E, C = cfg.n_experts, layers.capacity(cfg, S)
        n = sum(int((r["slots"] == E * C).sum()) for m in mods
                for r in m.routes)
        assert (n > 0) == dropped, (case, n)


# -- the pieces, on one process under the fake group ------------------------------

def test_placements_follow_the_resolved_spec():
    """Each spec entry splits its dim over its mesh axes in the mesh's
    order; an axis of one device replicates; no context, no placement."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (placements, resolve_spec,
                                                  shard)
    from repro_torch.launch.mesh import fake_group
    x = torch.ones(3)
    assert shard(x, "batch") is x and named_sharding((8,), ("batch",)) is None
    with fake_group(4):
        for shape, dm_shape in (((2, 2), (2, 2)), ((1, 4), (1, 4))):
            mesh = make_mesh(*shape, [torch.device("cpu")] * 4)
            dm = device_mesh(mesh, "cpu")
            with use_mesh(mesh, device_mesh=dm) as ctx:
                spec = resolve_spec((8, 16, 32), ("attn_batch", None,
                                                  "vocab"), ctx)
                got = placements(spec, dm)
                assert shard(x, "batch") is x     # a plain tensor
                assert named_sharding((8, 16, 32), ("attn_batch", None,
                                                    "vocab"))[1] == got
            if dm_shape == (2, 2):
                # vocab takes the model axis first, attn_batch the data one
                assert spec == ("data", None, "model")
                assert got == (Shard(0), Shard(2))
            else:
                assert spec == ("data", None, "model")
                assert got == (Replicate(), Shard(2))
        dm = device_mesh(make_mesh(2, 2, [torch.device("cpu")] * 4), "cpu")
        assert placements((("data", "model"),), dm) == (Shard(0), Shard(0))
        with pytest.raises(ValueError, match="order"):
            placements((("model", "data"),), dm)


def test_decode_over_a_sequence_split_cache_combines_to_the_whole():
    """The sharded decode over a cache split on its sequence, without
    ranks: one 20-slot cache cut into four 5-slot slices, each slice's
    plain (o, lse) at its local lengths clamp(len - 5 r, 0, 5), merged in
    slice order by ``combine_splits``, equals the plain decode over the
    whole cache in f32 within 2e-5 (GQA, 3 query heads a cache row).
    Lengths (0, 3, 5, 6, 17, 20): slices past a row's live prefix have no
    live key (lse -inf, o zeros) and weigh nothing; a row of length 0 has
    none anywhere and is zeros, as the whole cache's lse route gives."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator().manual_seed(3)
    lens, G, hd, S, R = (0, 3, 5, 6, 17, 20), 3, 16, 20, 4
    q = torch.randn(len(lens) * G, 1, hd, generator=gen)
    k, v = (torch.randn(len(lens), S, hd, generator=gen) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32).repeat_interleave(G)
    n = S // R
    parts = [da.decode_attention_plain(
        q, k[:, r * n:(r + 1) * n].contiguous(),
        v[:, r * n:(r + 1) * n].contiguous(),
        (lengths - r * n).clamp(0, n).to(torch.int32), with_lse=True)
        for r in range(R)]
    got = da.combine_splits(torch.stack([o for o, _ in parts]),
                            torch.stack([lse[:, None] for _, lse in parts]),
                            F32)
    whole, lse = da.decode_attention_plain(q, k, v, lengths, with_lse=True)
    live = lengths > 0
    assert got.dtype == F32 and got.shape == q.shape
    torch.testing.assert_close(got, whole, **TOL)
    torch.testing.assert_close(
        got[live], da.decode_attention_plain(q, k, v, lengths)[live], **TOL)
    assert not got[~live].any() and bool(torch.isneginf(lse[~live]).all())
    dead = [bool(torch.isneginf(lse_r[live]).any()) for _, lse_r in parts]
    assert dead == [False, True, True, True]


def test_plain_decode_lse_is_the_logsumexp_of_the_masked_scores():
    """The plain decode's ``with_lse`` route: each row's log-sum-exp is
    ``torch.logsumexp`` of its scaled (and capped) scores over its live
    keys, -inf at length 0; its output is the plain decode's in f32, zeros
    at length 0."""
    import math

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import softcap_scores
    gen = torch.Generator().manual_seed(5)
    hd, S = 16, 12
    lengths = torch.tensor([0, 1, 7, 12], dtype=torch.int32)
    q = torch.randn(4, 1, hd, generator=gen, dtype=torch.bfloat16)
    k, v = (torch.randn(2, S, hd, generator=gen, dtype=torch.bfloat16)
            for _ in range(2))
    for cap in (0.0, 1.5):
        o, lse = da.decode_attention_plain(q, k, v, lengths, softcap=cap,
                                           with_lse=True)
        assert o.dtype == F32 and lse.shape == (4,) and lse.dtype == F32
        scores = softcap_scores(torch.matmul(
            q.float(), k.float().repeat_interleave(2, 0).transpose(1, 2))
            / math.sqrt(hd), cap)[:, 0]
        keep = torch.arange(S)[None, :] < lengths[:, None]
        want = torch.logsumexp(torch.where(keep, scores, -math.inf), -1)
        assert torch.isneginf(lse[0]) and torch.isneginf(want[0])
        torch.testing.assert_close(lse[1:], want[1:], **TOL)
        assert not o[0].any()
        torch.testing.assert_close(
            o[1:].to(q.dtype), da.decode_attention_plain(
                q, k, v, lengths, softcap=cap)[1:], rtol=0, atol=0)


def test_decode_over_a_sequence_split_cache_on_the_meta_device():
    """The sharded decode's route over a cache split on its sequence, on
    meta DTensors under the fake group (rank 0 of (1, 4)): the kernel
    takes q whole on every head over the rank's quarter of the cache with
    the log-sum-exp, the pairs are gathered over the model axis in one
    all-gather, and the output lies as q; a window there raises, as does
    q split on its heads over the split."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import on_mesh, use_mesh
    from repro_torch.kernels import common, ops
    from repro_torch.launch.mesh import fake_group
    meta = torch.device("meta")
    with fake_group(4):
        mesh = make_mesh(1, 4, [torch.device("cpu")] * 4)
        with use_mesh(mesh, device_mesh=device_mesh(mesh, "cpu")) as ctx:
            def put(shape, spec, dtype=torch.bfloat16):
                local = [n // 4 if spec[i] == "model" else n
                         for i, n in enumerate(shape)]
                return on_mesh(torch.empty(local, dtype=dtype, device=meta),
                               shape, spec, ctx)
            q = put((2, 12, 1, 64), (None,) * 4)
            k = put((2, 2, 64, 64), (None, None, "model", None))
            lengths = put((2, 12), (None, None), torch.int32)
            assert k.placements == (Replicate(), Shard(2))
            counter = dryrun.CollectiveCounter()
            with common.local_calls() as calls, counter:
                out = ops.decode_attention(q, k, k, lengths)
            assert out.shape == q.shape and out.dtype == q.dtype
            assert out.placements == q.placements
            assert calls == [("decode_attention", (
                ((2, 12, 1, 64), "bfloat16"), ((2, 2, 16, 64), "bfloat16"),
                ((2, 2, 16, 64), "bfloat16"), ((2, 12), "int32")),
                (("softcap", 0.0), ("window", 0), ("with_lse", True)))]
            assert counter.log == [("all-gather", (1, 2, 12, 1, 65))]
            with pytest.raises(ValueError, match="window"):
                ops.decode_attention(q, k, k, lengths, window=8)
            heads = put((2, 12, 1, 64), (None, "model", None, None))
            with pytest.raises(ValueError, match="whole on mesh dim"):
                ops.decode_attention(heads, k, k, lengths)


@pytest.mark.parametrize("rank", range(RANKS))
def test_writes_to_a_sequence_split_cache_land_on_the_rank_that_holds_them(
        rank):
    """On a cache split four ways on its sequence (20 slots, 5 a rank),
    rank ``rank`` of the fake group (its shards real CPU tensors): a
    16-token prompt's keys land at the slots it holds, at local offsets
    (the prompt ends inside rank 3's slice), a decode step's slot only on
    the rank that holds it, and clearing from slot 7 zeroes only its own
    slots from there."""
    from repro_torch.distributed.sharding import on_mesh
    from repro_torch.launch.mesh import fake_group
    B_, KV, L, hd, n = 4, 2, 20, 3, 5
    mine = slice(rank * n, (rank + 1) * n)
    full = torch.arange(B_ * KV * L * hd, dtype=F32).view(B_, KV, L, hd)
    new = -torch.arange(B_ * KV * S * hd, dtype=F32).view(B_, KV, S, hd) - 1
    with fake_group(RANKS, rank):
        mesh = make_mesh(1, RANKS, [torch.device("cpu")] * RANKS)
        with use_mesh(mesh, device_mesh=device_mesh(mesh, "cpu")) as ctx:
            def split(t):
                return on_mesh(t[:, :, mine].clone(), t.shape,
                               (None, None, "model"), ctx)

            def whole(t, spec):
                return on_mesh(t.clone(), t.shape, spec, ctx)
            cache = split(full)
            layers.write_prompt(cache, whole(new, ()))
            want = full.clone()
            want[:, :, :S] = new
            torch.testing.assert_close(cache.to_local(), want[:, :, mine])
            slot = torch.tensor([3, 7, 12, 19])
            step = torch.full((B_, KV, hd), 0.5)
            layers.write_slot(whole(slot, ()), (cache, whole(step, ())))
            want[torch.arange(B_), :, slot] = step
            torch.testing.assert_close(cache.to_local(), want[:, :, mine])
            layers.clear_from(cache, 7)
            want[:, :, 7:] = 0
            torch.testing.assert_close(cache.to_local(), want[:, :, mine])


def test_norm_weight_gradient_is_a_partial_sum_of_the_row_shards():
    """fused_rmsnorm on rows split four ways: the output keeps x's
    placements, and w's gradient is reduced across the row shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import on_mesh, use_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_group
    meta = torch.device("meta")
    with fake_group(4):
        mesh = make_mesh(1, 4, [torch.device("cpu")] * 4)
        with use_mesh(mesh, device_mesh=device_mesh(mesh, "cpu")) as ctx:
            x = on_mesh(torch.empty(16, 64, device=meta), (64, 64),
                        ("model", None), ctx).requires_grad_(True)
            w = on_mesh(torch.empty(64, device=meta), (64,), (None,),
                        ctx).requires_grad_(True)
            counter = dryrun.CollectiveCounter()
            with counter:
                y = ops.fused_rmsnorm(x, w)
                assert y.placements == (Replicate(), Shard(0))
                assert counter.collectives == {}
                dx, dw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
            assert dx.placements == x.placements
            assert dw.placements == (Replicate(), Partial())
            assert dw.full_tensor().shape == (64,)


def test_unsharded_path_hands_the_kernels_contiguous_rows():
    """Off the mesh the model flattens batch and heads for the kernels,
    whose CUDA wrappers refuse a strided argument: every tensor they get
    is contiguous, one row a head, also for a batch of one row (where a
    flat view of the expanded lengths would have stride 0)."""
    import types

    from repro_torch.kernels import ops
    from repro_torch.params import init_params
    seen = []

    def checked(name):
        def call(*args, **kw):
            for t in args:
                assert t.is_contiguous(), (name, t.shape, t.stride())
            seen.append((name, tuple(args[0].shape)))
            return getattr(ops, name)(*args, **kw)
        return call
    spy = types.SimpleNamespace(**{n: checked(n) for n in (
        "fused_rmsnorm", "flash_attention", "decode_attention")})
    cfg = get_smoke("deepseek-67b")           # GQA: 8 heads over 2
    params = init_params(cfg, seed=0, device="cpu", dtype=F32)
    lm = LM.from_params(cfg, params, kernels=spy)
    for batch in (1, 3):
        toks = torch.randint(0, cfg.vocab, (batch, 5))
        with torch.no_grad():
            _, cache = lm.prefill(toks, 8)
            lm.decode_step(toks[:, 0], cache, torch.full((batch,), 5))
        H, hd = cfg.n_heads, cfg.hd
        assert ("flash_attention", (batch * H, 5, hd)) in seen
        assert ("decode_attention", (batch * H, 1, hd)) in seen


def test_shard_params_cuts_meta_parameters_and_refuses_values():
    """Each meta parameter becomes this rank's shard at its resolved
    placements, made directly (the global shape kept); a parameter with
    values is left to ``from_jax_numpy``'s sharded form."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.mesh import fake_group
    from repro_torch.params import init_params, param_specs, shard_params
    cfg = _config("deepseek-67b")
    specs = param_specs(cfg)
    with fake_group(4):
        mesh = make_mesh(2, 2, [torch.device("cpu")] * 4)
        dm = device_mesh(mesh, "cpu")
        with use_mesh(mesh, device_mesh=dm) as ctx:
            lm = shard_params(LM(cfg, device="meta", dtype=F32), ctx)
            params = dict(lm.named_parameters())
            assert set(params) == set(specs)
            for n, p in params.items():
                assert isinstance(p, DTensor) and p.is_meta, n
                spec = specs[n].spec(ctx)
                assert p.placements == placements(spec, dm), n
                assert tuple(p.shape) == tuple(specs[n].shape), n
                assert tuple(p.to_local().shape) == \
                    specs[n].local_shape(ctx), n
            assert any(p.to_local().shape != p.shape
                       for p in params.values())
            lm = LM.from_params(cfg, init_params(cfg, seed=0, device="cpu",
                                                 dtype=F32))
            with pytest.raises(ValueError, match="meta"):
                shard_params(lm, ctx)


def test_shard_params_draws_each_shard_as_init_params_draws():
    """With a device, each rank's shard is drawn as ``init_params`` draws a
    leaf, in parameter order from a generator seeded with the rank: N(0,
    1) in f32 times the leaf's std, rounded to the shard's dtype (bf16
    serving weights here), or zeros and ones; every shard is allocated
    before the first draw is cast into it, with the same values."""
    from repro_torch.launch.mesh import fake_group
    from repro_torch.params import jax_leaves, shard_params
    cfg = _config(QWEN)
    init = {n: leaf for leaf in jax_leaves(cfg).values() for n in leaf.names}
    with fake_group(4):
        mesh = make_mesh(1, 4, [torch.device("cpu")] * 4)
        with use_mesh(mesh, device_mesh=device_mesh(mesh, "cpu")) as ctx:
            lm = shard_params(LM(cfg, device="meta", dtype=torch.bfloat16),
                              ctx, device="cpu")
    gen = torch.Generator().manual_seed(0)
    dtypes = set()
    for name, p in lm.named_parameters():
        local = p.to_local()
        leaf = init[name]
        if leaf.init in ("zeros", "ones"):
            want = (torch.zeros if leaf.init == "zeros" else torch.ones)(
                local.shape, dtype=p.dtype)
        else:
            want = (torch.randn(local.shape, generator=gen) * leaf.std) \
                .to(p.dtype)
        assert local.dtype == p.dtype and torch.equal(local, want), name
        dtypes.add(p.dtype)
    assert dtypes == {torch.bfloat16, F32}


def test_moe_refuses_unsplit_experts_and_route_collection():
    """No fallback: experts that do not divide the model axis (JAX's
    resolver replicates them) raise with the reason, as does collecting
    routes (the path check's) under a device mesh."""
    mesh = make_mesh(1, 4, [torch.device("cpu")] * 4)
    six = _config(MOONSHOT).with_(n_experts=6)
    with dryrun.sharded_step(mesh):
        with pytest.raises(ValueError, match="6 experts are not split"):
            dryrun.trace_prefill(six, B, S, F32)
        lm = dryrun.meta_lm(_config(MOONSHOT), dtype=F32)
        lm.layers[1].moe.routes = []
        with pytest.raises(ValueError, match="one device"):
            lm.prefill(torch.zeros(B, S, dtype=torch.int64, device="meta"),
                       MAX_LEN)
