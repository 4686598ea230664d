"""The port's training substrate against the JAX package's (mirrors
tests/test_training.py), on the deepseek-7b smoke (and the granite smoke
for the MoE aux loss), JAX in f32 compute as test_torch_models.py runs
it, the weights carried across by ``from_jax_numpy``.

Tolerances, stated before any run:
* ``LM.loss``: rtol 1e-5 (both f32; chunked CE over the same logits).
* gradients: each leaf within 1e-4 of that leaf's max |g| (autodiff of
  two f32 graphs whose sums are ordered differently).
* ``adamw_update`` on the same numpy gradients: 1e-6 absolute.
* ``make_train_step``, 5 steps: losses rtol 1e-4; parameters within
  2.5 lr (AdamW's first update is +-lr for any |g| >> eps, so a gradient
  that differs by rounding can flip an element's sign).
* microbatches 4 against 1: test_training.py:49-51's rel 2e-2, 5e-3.
* remat against no remat, batches, checkpoints and compression: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402,E501
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed.elastic import StepWatchdog as JaxWatchdog  # noqa: E402
from repro.distributed.elastic import viable_meshes as jax_meshes  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.training import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.training import adamw_update as jax_adamw  # noqa: E402
from repro.training import init_opt_state as jax_init_opt  # noqa: E402
from repro.training import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.distributed import (StepWatchdog, compress_int8,  # noqa: E402
                                     compress_topk, compressed_tree_allreduce,
                                     decompress_int8, init_error,
                                     viable_meshes)
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.params import from_jax_numpy, to_jax_numpy  # noqa: E402
from repro_torch.training import (SyntheticLM, adamw_update,  # noqa: E402
                                  init_opt_state, leaf_order,
                                  load_train_state, loss_and_grads,
                                  make_train_step, state_like, train_state)


class f32_compute:
    """JAX's model in f32 compute, restored to bf16 on exit."""

    def __enter__(self):
        jl.set_compute_dtype(jnp.float32)

    def __exit__(self, *exc):
        jl.set_compute_dtype(jnp.bfloat16)


def build(arch):
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree


def port_lm(cfg, tree):
    lm = LM.from_params(cfg, from_jax_numpy(tree, cfg, "cpu", torch.float32))
    for p in lm.parameters():
        p.requires_grad_(True)
    return lm


@pytest.fixture(scope="module")
def setup():
    return build("deepseek-7b")


def batch_of(vocab, seq, batch, seed=0):
    b = JaxSyntheticLM(vocab=vocab, seq_len=seq, batch=batch,
                       seed=seed).next_batch()
    return {k: np.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_loss_and_grads_match_jax(setup):
    """Two CE chunks (S 512), z-loss; every gradient leaf, stacked back
    into JAX's tree by to_jax_numpy."""
    jcfg, cfg, jparams, tree = setup
    b = batch_of(cfg.vocab, 512, 2)
    with f32_compute():
        jloss, jgrads = jax.value_and_grad(
            lambda p: JaxLM(jcfg).loss(p, b["tokens"], b["targets"]))(jparams)
    lm = port_lm(cfg, tree)
    loss, grads = loss_and_grads(lm, torch_batch(b), TrainConfig())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = to_jax_numpy(grads, cfg)
    for path, want in leaves(jgrads):
        g = got
        for p in path:
            g = g[p.key]
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


# gemma3 at narrow widths that keep the real head dims (hd 240 and 168):
# 7 layers, a group of 5 local layers (window 16) and a global one, then
# a local tail
GEMMA_WIDE = {"gemma3-12b": dict(d_model=480, n_heads=2, n_kv_heads=1,
                                 n_layers=7),
              "gemma3-27b": dict(d_model=336, n_heads=2, n_kv_heads=1,
                                 n_layers=7)}
FLOOR_DRAWS = 3
FLOOR_CEILING = {"gemma3-12b": 0.1, "gemma3-27b": 1e-2}


def rel_by_leaf(got, want_tree):
    """{leaf: max |got - want| / max |want|} over the leaves of want_tree,
    got in the same nesting (to_jax_numpy's)."""
    out = {}
    for path, want in leaves(want_tree):
        g = got
        for p in path:
            g = g[p.key]
        want = np.asarray(want)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(g - want).max() / np.abs(want).max())
    return out


@pytest.mark.parametrize("arch", list(GEMMA_WIDE))
def test_gemma3_grads_match_jax_at_the_rounding_floor(arch):
    """Every gradient leaf of loss_and_grads against jax.value_and_grad at
    gemma3's real head dims (S 64, batch 2, both in f32; the port's
    attention backward there is the kernels' on the card).

    The tolerance is each leaf's own rounding floor on this random-weight
    stack, measured here: each f32 weight nudged by one ulp up or down at
    random (np.nextafter, signs from a numpy generator of seed 1), the
    port's gradients computed again, and the leaf's max |nudged -
    unnudged| / max |g|, the largest over FLOOR_DRAWS draws. Each leaf's
    max |port - JAX| / max |JAX| must be within twice its own floor, and
    each floor under FLOOR_CEILING, so a floor that grows fails rather
    than widening its own tolerance (the floors reach 0.053 at hd 240,
    where the two heads' saturated softmax amplifies rounding, and 4.1e-3
    at hd 168); the losses within 1e-5."""
    w = GEMMA_WIDE[arch]
    jcfg = dataclasses.replace(jax_get_smoke(arch), **w)
    cfg = get_smoke(arch).with_(**w)
    assert cfg.hd == {"gemma3-12b": 240, "gemma3-27b": 168}[arch]
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    b = batch_of(cfg.vocab, 64, 2)
    with f32_compute():
        jloss, jgrads = jax.value_and_grad(
            lambda p: JaxLM(jcfg).loss(p, b["tokens"], b["targets"]))(jparams)

    def port(tr):
        loss, grads = loss_and_grads(port_lm(cfg, tr), torch_batch(b),
                                     TrainConfig())
        return float(loss), to_jax_numpy(grads, cfg)
    loss, got = port(tree)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    rng = np.random.default_rng(1)
    floor = {}
    for _ in range(FLOOR_DRAWS):
        nudged = jax.tree.map(
            lambda a: np.nextafter(a, np.where(rng.random(a.shape) < 0.5,
                                               -np.inf, np.inf).astype(a.dtype))
            if a.dtype == np.float32 else a, tree)
        for k, v in rel_by_leaf(port(nudged)[1], got).items():
            floor[k] = max(floor.get(k, 0.0), v)
    rel = rel_by_leaf(got, jgrads)
    assert len(rel) == len(leaves(jgrads)) == len(floor)
    high = {k: v for k, v in floor.items() if not v < FLOOR_CEILING[arch]}
    assert not high, high
    bad = {k: (v, floor[k]) for k, v in rel.items() if not v <= 2 * floor[k]}
    assert not bad, bad


def test_granite_loss_includes_the_moe_aux_term():
    jcfg, cfg, jparams, tree = build("granite-moe-3b-a800m")
    b = batch_of(cfg.vocab, 64, 2)
    with f32_compute():
        jloss = JaxLM(jcfg).loss(jparams, b["tokens"], b["targets"])
    lm = port_lm(cfg, tree)
    tb = torch_batch(b)
    loss = lm.loss(tb["tokens"], tb["targets"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    with torch.no_grad():
        x = lm.embed_tokens(tb["tokens"])
        _, aux = lm.hidden_train(x, torch.arange(64).expand(2, 64),
                                 remat=False)
    assert float(aux) > 0
    assert 0.01 * float(aux) / cfg.n_layers > 1e-4


def test_adamw_matches_jax_on_the_same_grads(setup):
    """Three steps fed the same numpy gradients; only the second's global
    norm is clipped (grad_clip 1.0)."""
    jcfg, cfg, jparams, tree = setup
    tcfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp, jopt = jparams, jax_init_opt(jparams)
    params = from_jax_numpy(tree, cfg, "cpu", torch.float32)
    opt = init_opt_state(params)
    order = leaf_order(params, cfg)
    rng = np.random.default_rng(0)
    # ~115 k parameters: gradients of std 1e-3 have a norm of ~0.34, of
    # std 1.0 one of ~340, which the clip at 1.0 scales
    for step, scale in enumerate((1e-3, 1.0, 2e-3)):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32), tree)
        jp, jopt, jstats = jax_adamw(g, jopt, jp, JaxTrainConfig(**tcfg))
        gt = from_jax_numpy(g, cfg, "cpu", torch.float32)
        opt, stats = adamw_update(params, gt, opt, TrainConfig(**tcfg),
                                  order)
        clip = 1.0 / (float(jstats["grad_norm"]) + 1e-9)
        assert (clip < 1.0) == (step == 1)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        assert stats["lr"] == float(jstats["lr"])
        for name, state in (("params", params), ("m", opt["m"]),
                            ("v", opt["v"])):
            want = {"params": jp, "m": jopt["m"], "v": jopt["v"]}[name]
            got = to_jax_numpy(state, cfg)
            for path, w in leaves(want):
                a = got
                for p in path:
                    a = a[p.key]
                np.testing.assert_allclose(a, np.asarray(w), rtol=0,
                                           atol=1e-6, err_msg=name)
    assert opt["step"] == int(jopt["step"]) == 3


def test_train_step_matches_jax_over_five_steps(setup):
    jcfg, cfg, jparams, tree = setup
    lr = 1e-3
    kw = dict(lr=lr, total_steps=5, warmup_steps=1)
    jdata = JaxSyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4)
    with f32_compute():
        jstep = jax.jit(jax_train_step(JaxLM(jcfg), JaxTrainConfig(**kw)))
        jp, jopt, jlosses = jparams, jax_init_opt(jparams), []
        for _ in range(5):
            jp, jopt, m = jstep(jp, jopt, jdata.next_batch())
            jlosses.append(float(m["loss"]))
    lm = port_lm(cfg, tree)
    step_fn = make_train_step(lm, TrainConfig(**kw))
    opt = init_opt_state(dict(lm.named_parameters()))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4)
    losses = []
    for _ in range(5):
        opt, m = step_fn(opt, data.next_batch())
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    got = to_jax_numpy(lm, cfg)
    for path, w in leaves(jp):
        a = got
        for p in path:
            a = a[p.key]
        np.testing.assert_allclose(a, np.asarray(w), rtol=0, atol=2.5 * lr)


def test_microbatches_match_full_batch(setup):
    """As test_training.py's: 4 microbatches against 1 on one batch."""
    _, cfg, _, tree = setup
    b = torch_batch(batch_of(cfg.vocab, 32, 8))
    out = []
    for mb in (1, 4):
        lm = port_lm(cfg, tree)
        step_fn = make_train_step(lm, TrainConfig(microbatches=mb))
        _, m = step_fn(init_opt_state(dict(lm.named_parameters())), b)
        out.append((float(m["loss"]), {n: p.detach().clone()
                                       for n, p in lm.named_parameters()}))
    (l1, p1), (l4, p4) = out
    assert l1 == pytest.approx(l4, rel=2e-2)
    assert max(float((p1[n] - p4[n]).abs().max()) for n in p1) < 5e-3


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-12b"])
def test_remat_grads_equal_no_remat_grads(arch):
    cfg = get_smoke(arch)
    _, _, _, tree = build(arch) if arch == "deepseek-7b" else \
        (None, None, None, None)
    if tree is None:
        from repro_torch.params import init_params
        params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        lm = LM.from_params(cfg, params)
        for p in lm.parameters():
            p.requires_grad_(True)
    else:
        lm = port_lm(cfg, tree)
    b = torch_batch(batch_of(cfg.vocab, 300, 2))
    tcfg = TrainConfig(microbatches=2)
    la, ga = loss_and_grads(lm, b, tcfg, remat=True)
    ga = {n: g.clone() for n, g in ga.items()}
    lb, gb = loss_and_grads(lm, b, tcfg, remat=False)
    assert torch.equal(la, lb)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def test_synthetic_batches_match_jax_and_resume():
    j = JaxSyntheticLM(vocab=1000, seq_len=16, batch=2, seed=1)
    t = SyntheticLM(vocab=1000, seq_len=16, batch=2, seed=1)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch()
        for k in ("tokens", "targets"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    saved = t.state_dict()
    want = t.next_batch()
    b = SyntheticLM(vocab=1000, seq_len=16, batch=2, seed=1)
    b.load_state(saved)
    assert torch.equal(b.next_batch()["tokens"], want["tokens"])


def jax_state(jparams, jopt, data_state):
    return {"params": jparams, "opt": jopt, "data": data_state}


def test_checkpoints_cross_load_with_equal_hashes(tmp_path, setup):
    """A JAX checkpoint restores into the port and the reverse; the same
    state hashes the same in both (keys, dtypes and bytes equal)."""
    _, cfg, jparams, tree = setup
    rng = np.random.default_rng(5)
    jopt = jax_init_opt(jparams)
    jopt = {"m": jax.tree.map(lambda a: jnp.asarray(
                rng.standard_normal(a.shape).astype(np.float32)), jopt["m"]),
            "v": jax.tree.map(lambda a: jnp.asarray(
                rng.random(a.shape).astype(np.float32)), jopt["v"]),
            "step": jnp.asarray(7, jnp.int32)}
    data_state = {"seed": 3, "step": 9}
    JaxCheckpointManager(str(tmp_path / "jax")).save(
        7, jax_state(jparams, jopt, data_state))
    # JAX -> port
    lm = port_lm(cfg, jax.tree.map(np.zeros_like, tree))
    opt = init_opt_state(dict(lm.named_parameters()))
    mgr = CheckpointManager(str(tmp_path / "jax"))
    step, state = mgr.restore_latest(state_like(cfg))
    assert step == 7
    opt, data = load_train_state(state, lm, opt)
    assert opt["step"] == 7 and data == data_state
    for path, w in leaves(jparams):
        a = to_jax_numpy(lm, cfg)
        for p in path:
            a = a[p.key]
        np.testing.assert_array_equal(a, np.asarray(w))
    # port -> the same bytes, the same hash; and JAX restores it
    port = CheckpointManager(str(tmp_path / "port"))
    port.save(7, train_state(lm, opt, data))
    assert port.meta(7)["hash"] == mgr.meta(7)["hash"]
    assert port.meta(7)["keys"] == mgr.meta(7)["keys"]
    # numpy leaves in `like`: JAX's restore reads each leaf's dtype, which
    # a Python int (its own launcher's data state) does not have
    jstep, jstate = JaxCheckpointManager(str(tmp_path / "port")) \
        .restore_latest(jax_state(jparams, jax_init_opt(jparams),
                                  {"seed": np.asarray(0),
                                   "step": np.asarray(0)}))
    assert jstep == 7 and int(jstate["opt"]["step"]) == 7
    for (path, w), (_, g) in zip(leaves(jopt), leaves(jstate["opt"])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(jstate["data"]["step"]) == 9


def test_checkpoint_keep_and_corrupt_newest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    state = {"w": torch.arange(6.0).view(2, 3), "step": np.asarray(7)}
    for step in (7, 9, 11):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.steps() == [9, 11]
    step, got = mgr.restore_latest(state)
    assert step == 11 and np.array_equal(got["w"], state["w"].numpy())
    (tmp_path / "step_00000011" / "arrays.npz").write_bytes(b"garbage")
    step, _ = mgr.restore_latest(state)
    assert step == 9


def test_int8_and_topk_match_jax():
    rng = np.random.default_rng(2)
    g = rng.standard_normal(300).astype(np.float32)
    e = (rng.standard_normal(300) * 0.01).astype(np.float32)
    g[:4] = [0.5, -0.5, 0.5, 2.0]          # ties of |g| for top-k
    jq, js, je = jcomp.compress_int8(jnp.asarray(g), jnp.asarray(e))
    q, s, e2 = compress_int8(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(e2.numpy(), np.asarray(je))
    np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                  np.asarray(jcomp.decompress_int8(jq, js)))
    tie = np.tile(np.float32([1.0, -1.0, 0.25, -0.25]), 40)   # all tied
    for x in (g.reshape(20, 15), tie):
        jv, ji, je = jcomp.compress_topk(jnp.asarray(x), jnp.zeros_like(x),
                                         frac=0.1)
        v, i, e3 = compress_topk(torch.from_numpy(x), torch.zeros(x.shape),
                                 frac=0.1)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(e3.numpy(), np.asarray(je))


def test_compressed_allreduce_is_the_identity_on_one_process():
    grads = {"a": torch.randn(5, 7), "b": torch.randn(3)}
    errors = init_error(grads)
    out, err = compressed_tree_allreduce(grads, errors)
    for n in grads:
        q, s, e = compress_int8(grads[n], errors[n])
        assert torch.equal(out[n], decompress_int8(q, s))
        assert torch.equal(err[n], e)


def test_compressed_allreduce_averages_over_a_process_group(tmp_path):
    """With a torch.distributed group the dequantised gradients are summed
    over it and divided by its size (a group of one, gloo on the CPU)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        grads = {"a": torch.randn(4, 3)}
        out, _ = compressed_tree_allreduce(grads, init_error(grads),
                                           group=dist.group.WORLD)
        q, s, _ = compress_int8(grads["a"], torch.zeros(4, 3))
        assert torch.equal(out["a"], decompress_int8(q, s))
    finally:
        dist.destroy_process_group()


def test_watchdog_and_meshes_match_jax():
    a, b = StepWatchdog(factor=3.0), JaxWatchdog(factor=3.0)
    for dt in [1.0] * 10 + [10.0, 1.1, 0.9, 4.0]:
        assert a.record(dt) == b.record(dt)
    for n in (1, 8, 12, 256):
        assert viable_meshes(n) == jax_meshes(n)


def test_train_launcher_on_the_cpu_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "32", "--log-every",
            "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_launch.main(args + ["--steps", "3"])
    first = capsys.readouterr().out
    assert "step     2 loss" in first
    train_launch.main(args + ["--steps", "5"])
    second = capsys.readouterr().out
    assert "resumed from step 3" in second
    assert "step     3 loss" in second and "step     2 loss" not in second
    assert CheckpointManager(str(tmp_path)).steps()[-1] == 5
