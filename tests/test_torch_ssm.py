"""The port's zamba path (repro_torch.models.ssm, the zamba branch of
repro_torch.models.transformer, repro_torch.kernels.ssm_scan) against the
JAX package on the zamba2-1.2b smoke config (8 layers, d 64, chunk 16).

The plain ssm_scan is held against the JAX oracle and the Pallas kernel
in interpret mode (f32 2e-4, test_kernels.py:87); the layers, the LM and
the serving engine against the JAX model in f32 compute on the same
weights (the bridge) and the same inputs (model tolerance 2e-3,
test_models.py:61; engine decisions identical).
"""
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.distributed.params import is_spec  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels import ssm_scan as pallas_ssm  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import zamba_groups as jax_zamba_groups  # noqa: E402
from repro.serving import LiveRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ops, plain  # noqa: E402
from repro_torch.kernels.ssm_scan import (chunk_cumsum,  # noqa: E402
                                          ssm_scan_cuda, ssm_scan_plain)
from repro_torch.models import LM, ssm  # noqa: E402
from repro_torch.models.transformer import zamba_groups  # noqa: E402
from repro_torch.params import (from_jax_numpy, init_params,  # noqa: E402
                                jax_leaves)
from repro_torch.serving import LiveRequest, ServingEngine  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = dict(rtol=2e-3, atol=2e-3)            # test_models.py:61
KTOL = dict(rtol=2e-4, atol=2e-4)           # test_kernels.py:87


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_smoke(ARCH)
    cfg = get_smoke(ARCH)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    p32 = from_jax_numpy(tree, cfg, "cpu", torch.float32)
    return jcfg, cfg, jparams, tree, p32, LM.from_params(cfg, p32)


class f32_compute:
    """JAX's model in f32 compute, restored to bf16 on exit."""

    def __enter__(self):
        jl.set_compute_dtype(jnp.float32)

    def __exit__(self, *exc):
        jl.set_compute_dtype(jnp.bfloat16)


def jax_layer(tree, i: int, cfg) -> dict:
    """The JAX parameters of SSM layer i (blocks (G, every) then tail)."""
    G, _ = zamba_groups(cfg)
    every = cfg.shared_attn_every
    if i < G * every:
        return {k: jnp.asarray(v[i // every, i % every])
                for k, v in tree["blocks"].items()}
    return {k: jnp.asarray(v[i - G * every]) for k, v in tree["tail"].items()}


def assert_close_to_scale(out, exp, tol=2e-3):
    """max |out - exp| within ``tol`` of max |exp|: for recurrent states,
    whose entries sum hundreds of f32 products of mixed sign (a small
    entry carries the rounding of the large ones)."""
    exp = np.asarray(exp)
    assert out.shape == exp.shape
    assert np.abs(out - exp).max() <= tol * np.abs(exp).max()


def tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


def scan_inputs(rng, bh, s, hd, ds, chunk, bh_bc=None):
    """xbar, B, C, cumlog as numpy f32 (test_kernels.py:77's scales)."""
    bh_bc = bh_bc or bh
    xb = (rng.standard_normal((bh, s, hd)) * 0.5).astype(np.float32)
    B = (rng.standard_normal((bh_bc, s, ds)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((bh_bc, s, ds)) * 0.5).astype(np.float32)
    loga = -np.abs(rng.standard_normal((bh, s)) * 0.2).astype(np.float32)
    pad = -s % chunk
    cum = np.pad(loga, ((0, 0), (0, pad))).reshape(bh, -1, chunk) \
        .cumsum(-1).reshape(bh, -1)[:, :s]
    return xb, B, C, np.ascontiguousarray(cum, np.float32)


def test_config_copy_matches_jax():
    assert asdict(get_config(ARCH)) == asdict(jax_get_config(ARCH))
    assert asdict(get_smoke(ARCH)) == asdict(jax_get_smoke(ARCH))
    assert zamba_groups(get_config(ARCH)) == \
        jax_zamba_groups(jax_get_config(ARCH)) == (6, 2)
    assert ssm.ssm_dims(get_config(ARCH)) == \
        jssm.ssm_dims(jax_get_config(ARCH)) == (4096, 64, 64, 64)


# -- the plain scan against the oracle and the Pallas kernel ---------------

@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("hd,ds", [(64, 16), (64, 64), (128, 32)])
def test_ssm_scan_plain_matches_ref_and_pallas(chunk, hd, ds):
    rng = np.random.default_rng(chunk + hd + ds)
    arrs = scan_inputs(rng, 2, 256, hd, ds, chunk)
    y, h = ssm_scan_plain(*map(torch.from_numpy, arrs), chunk=chunk)
    exp = ref.ssm_scan_ref(*map(jnp.asarray, arrs), chunk=chunk)
    pal = pallas_ssm(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    assert y.dtype == torch.float32 and tuple(h.shape) == (2, hd, ds)
    np.testing.assert_allclose(y.numpy(), np.asarray(exp), **KTOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(pal), **KTOL)


def test_ssm_scan_plain_final_state_is_the_recurrence():
    """h after S steps of h <- a h + xbar^T B, a from the cumlog steps."""
    rng = np.random.default_rng(1)
    xb, B, C, cum = scan_inputs(rng, 2, 96, 64, 16, 32)
    _, h = ssm_scan_plain(*map(torch.from_numpy, (xb, B, C, cum)), chunk=32)
    step = np.concatenate([cum[:, :1], np.diff(cum, axis=1)], axis=1)
    step[:, ::32] = cum[:, ::32]
    exp = np.zeros((2, 64, 16))
    for t in range(96):
        exp = exp * np.exp(step[:, t])[:, None, None] + \
            xb[:, t, :, None] * B[:, t, None, :]
    np.testing.assert_allclose(h.numpy(), exp, **KTOL)


def test_ssm_scan_plain_ragged_equals_padded():
    """A short last chunk is the padded scan's prefix (zero inputs and
    zero log-decay past S), output and state, as ssm_block pads."""
    rng = np.random.default_rng(2)
    xb, B, C, cum = scan_inputs(rng, 3, 100, 64, 32, 32)
    y, h = ssm_scan_plain(*map(torch.from_numpy, (xb, B, C, cum)), chunk=32)
    pad = ((0, 0), (0, 28), (0, 0))
    cum_p = np.concatenate([cum, np.repeat(cum[:, -1:], 28, 1)], 1)
    exp = ref.ssm_scan_ref(jnp.asarray(np.pad(xb, pad)),
                           jnp.asarray(np.pad(B, pad)),
                           jnp.asarray(np.pad(C, pad)), jnp.asarray(cum_p),
                           chunk=32)
    yp, hp = ssm_scan_plain(*map(torch.from_numpy, (
        np.pad(xb, pad), np.pad(B, pad), np.pad(C, pad), cum_p)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(exp)[:, :100], **KTOL)
    np.testing.assert_allclose(h.numpy(), hp.numpy(), **KTOL)


def test_ssm_scan_plain_shared_bc_rows():
    """Row bh reads B/C row bh // (BH // BH_bc): the same as repeating."""
    rng = np.random.default_rng(3)
    xb, B, C, cum = scan_inputs(rng, 4, 64, 32, 16, 16, bh_bc=2)
    y, h = ssm_scan_plain(*map(torch.from_numpy, (xb, B, C, cum)), chunk=16)
    yr, hr = ssm_scan_plain(*map(torch.from_numpy, (
        xb, B.repeat(2, 0), C.repeat(2, 0), cum)), chunk=16)
    exp = ref.ssm_scan_ref(jnp.asarray(xb), jnp.asarray(B.repeat(2, 0)),
                           jnp.asarray(C.repeat(2, 0)), jnp.asarray(cum),
                           chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(exp), **KTOL)
    assert torch.equal(y, yr) and torch.equal(h, hr)


def test_chunk_cumsum_resets_every_chunk():
    """Reset every chunk, and contiguous for a short last chunk (the CUDA
    kernel takes only contiguous tensors)."""
    loga = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 37)).astype(np.float32))
    cum = chunk_cumsum(loga, 16)
    assert cum.shape == (2, 37) and cum.is_contiguous()
    for c0 in (0, 16, 32):
        torch.testing.assert_close(cum[:, c0:c0 + 16],
                                   loga[:, c0:c0 + 16].cumsum(-1))


def test_ops_ssm_scan_dispatches_cpu_to_plain_without_counting():
    rng = np.random.default_rng(5)
    args = list(map(torch.from_numpy, scan_inputs(rng, 2, 40, 16, 16, 16)))
    ops.reset_launch_counts()
    y, h = ops.ssm_scan(*args, chunk=16)
    yp, hp = plain.ssm_scan(*args, chunk=16)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    assert ops.launch_counts()["ssm_scan"] == 0


def test_ssm_scan_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(6)
    args = list(map(torch.from_numpy, scan_inputs(rng, 2, 40, 16, 16, 16)))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ssm_scan_cuda(*args, chunk=16)
    assert ops.launch_counts()["ssm_scan"] == 0


# -- the layer against JAX ---------------------------------------------------

@pytest.mark.parametrize("S", [32, 21])
def test_ssm_block_matches_jax(setup, S):
    """Output and final state; S = 32 is two full chunks of 16, S = 21
    has a short last chunk (JAX pads it)."""
    jcfg, cfg, _, tree, _, lm = setup
    x = np.random.default_rng(S).standard_normal((2, S, 64), np.float32)
    with f32_compute():
        jout, jst = jssm.ssm_block(jax_layer(tree, 1, cfg), jnp.asarray(x),
                                   jcfg)
    out, h = ssm.ssm_block(lm.layers[1], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jst["h"]), **TOL)


def test_ssm_decode_matches_jax(setup):
    jcfg, cfg, _, tree, _, lm = setup
    rng = np.random.default_rng(7)
    _, nh, hd, ds = ssm.ssm_dims(cfg)
    x = rng.standard_normal((2, 1, 64), np.float32)
    h0 = rng.standard_normal((2, nh, hd, ds)).astype(np.float32)
    with f32_compute():
        jout, jst = jssm.ssm_decode(jax_layer(tree, 6, cfg), jnp.asarray(x),
                                    jcfg, {"h": jnp.asarray(h0)})
    out, h = ssm.ssm_decode(lm.layers[6], torch.from_numpy(x), cfg,
                            torch.from_numpy(h0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jst["h"]), **TOL)


def test_ssm_init_state_matches_jax():
    cfg = get_smoke(ARCH)
    h = ssm.ssm_init_state(cfg, 3, "cpu")
    exp = jssm.ssm_init_state(jax_get_smoke(ARCH), 3)["h"]
    assert tuple(h.shape) == exp.shape and h.dtype == torch.float32
    assert not h.any()


# -- the LM against JAX --------------------------------------------------------

def test_logits_train_matches_jax(setup):
    jcfg, _, jparams, _, _, lm = setup
    toks = tokens((2, 24))
    with f32_compute():
        exp = JaxLM(jcfg).logits_train(jparams, jnp.asarray(toks))
    out = lm.logits_train(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and tuple(out.shape) == exp.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("S", [20, 32])
def test_prefill_and_decode_steps_match_jax(setup, S):
    """Prefill + 4 decode steps: logits, the 8 SSM states (JAX: 2 groups
    of 3 + 2 tail layers) and the 2 shared KV caches."""
    jcfg, cfg, jparams, _, _, lm = setup
    B, extra = 2, 4
    toks = tokens((B, S + extra), seed=7)
    jlm = JaxLM(jcfg)
    with f32_compute():
        jlogits, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :S]),
                                      max_len=S + extra)
        jsteps = []
        for i in range(extra):
            jd, jcache = jlm.decode_step(
                jparams, jnp.asarray(toks[:, S + i]), jcache,
                jnp.full((B,), S + i, jnp.int32))
            jsteps.append(np.asarray(jd))
    logits, cache = lm.prefill(torch.from_numpy(toks[:, :S]), S + extra)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i in range(extra):
        d, cache = lm.decode_step(torch.from_numpy(toks[:, S + i]), cache,
                                  torch.full((B,), S + i))
        np.testing.assert_allclose(d.numpy(), jsteps[i], **TOL)
    G, tail = zamba_groups(cfg)
    jh = np.concatenate([np.asarray(jcache["ssm_h"]).reshape(
        (-1,) + jcache["ssm_h"].shape[2:]), np.asarray(jcache["tail_h"])])
    assert tuple(cache["ssm_h"].shape) == jh.shape == (8, B, 2, 64, 16)
    assert_close_to_scale(cache["ssm_h"].numpy(), jh)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache[kv].numpy(),
                                   np.asarray(jcache["shared"][kv]), **TOL)


def test_prefill_decode_consistency(setup):
    """Teacher-forced decode reproduces the parallel logits (port only)."""
    _, _, _, _, _, lm = setup
    B, S, extra = 2, 27, 4
    toks = torch.from_numpy(tokens((B, S + extra), seed=9))
    full = lm.logits_train(toks)
    logits, cache = lm.prefill(toks[:, :S], max_len=S + extra)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    for i in range(extra):
        d, cache = lm.decode_step(toks[:, S + i], cache,
                                  torch.full((B,), S + i))
        torch.testing.assert_close(d[:, 0], full[:, S + i], **TOL)


def test_prefill_launch_path_on_cpu_counts_nothing(setup):
    """On the CPU the scan takes the plain version: no kernel launch is
    counted, and the kernels and plain namespaces give the same logits."""
    _, cfg, _, _, p32, lm = setup
    toks = torch.from_numpy(tokens((1, 18), seed=11))
    ops.reset_launch_counts()
    a, _ = lm.prefill(toks, 24)
    b, _ = LM.from_params(cfg, p32, kernels=plain).prefill(toks, 24)
    assert torch.equal(a, b)
    assert sum(ops.launch_counts().values()) == 0


# -- parameters ----------------------------------------------------------------

def test_bridge_unstacks_groups_and_tail(setup):
    _, cfg, _, tree, _, _ = setup
    p = from_jax_numpy(tree, cfg, "cpu", torch.bfloat16)
    G, tail = zamba_groups(cfg)
    every = cfg.shared_attn_every
    n_ssm, n_attn, n_mlp = 10, 5, 4
    assert len(p) == 2 + cfg.n_layers * n_ssm + n_attn + n_mlp
    for i in range(cfg.n_layers):
        src = (tree["blocks"]["w_xz"][i // every, i % every]
               if i < G * every else tree["tail"]["w_xz"][i - G * every])
        np.testing.assert_array_equal(
            p[f"layers.{i}.w_xz"].float().numpy(),
            np.asarray(jnp.asarray(src).astype(jnp.bfloat16)
                       .astype(jnp.float32)))
    for name in ("layers.0.w_xz", "layers.7.w_out", "shared_attn.wq",
                 "shared_mlp.w_down", "layers.3.w_dt"):
        assert p[name].dtype == torch.bfloat16, name
    for name in ("layers.0.D", "layers.0.A_log", "layers.0.dt_bias",
                 "layers.0.out_norm", "shared_attn.norm", "embed"):
        assert p[name].dtype == torch.float32, name
    assert "lm_head" not in p                       # tied embeddings
    np.testing.assert_array_equal(p["shared_attn.wq"].float().numpy(),
                                  np.asarray(jnp.asarray(
                                      tree["shared_attn"]["wq"])
                                      .astype(jnp.bfloat16)
                                      .astype(jnp.float32)))


def test_init_params_std_matches_materialize(setup):
    """Leaf by leaf, the on-device initialiser draws with materialize's
    std: fan_in = G for the (G, every) blocks, the tail count for the
    tail and d for the shared block; D is ones."""
    _, cfg, _, tree, _, _ = setup
    p = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    checked = 0
    for path, leaf in jax_leaves(cfg).items():
        ref_leaf = tree
        for k in path:
            ref_leaf = ref_leaf[k]
        mine = np.stack([p[n].numpy() for n in leaf.names]).reshape(
            leaf.shape)
        assert mine.shape == ref_leaf.shape, path
        if leaf.init != "normal":
            np.testing.assert_array_equal(mine, ref_leaf)
            continue
        np.testing.assert_allclose(mine.std(), ref_leaf.std(), rtol=0.15)
        np.testing.assert_allclose(mine.std(), leaf.std, rtol=0.15)
        checked += 1
    assert checked == 2 * 5 + 4 + 3 + 1          # blocks, tail, shared, embed
    assert not p["layers.0.dt_bias"].any()
    assert bool((p["layers.5.D"] == 1).all())


def test_init_std_rule_at_full_width():
    """The full-width spec table against the JAX ParamSpecs (no arrays):
    std 1/sqrt(6) for the blocks (G = 6), 1/sqrt(2) for the tail, 1/sqrt(d)
    for the shared block."""
    cfg = get_config(ARCH)
    specs = model_specs(jax_get_config(ARCH))
    leaves = jax_leaves(cfg)
    assert len(leaves) == 2 + 2 * 10 + 5 + 4
    for path, leaf in leaves.items():
        spec = specs
        for k in path:
            spec = spec[k]
        assert is_spec(spec) and spec.shape == leaf.shape, path
        assert spec.init == leaf.init, path
        if spec.init == "normal":
            fan_in = spec.shape[0]
            assert leaf.std == pytest.approx(spec.scale / np.sqrt(fan_in))
    assert leaves[("blocks", "w_xz")].std == pytest.approx(1 / np.sqrt(6))
    assert leaves[("tail", "w_xz")].std == pytest.approx(1 / np.sqrt(2))
    assert leaves[("shared_attn", "wq")].std == pytest.approx(
        1 / np.sqrt(2048))
    assert leaves[("blocks", "w_xz")].names[-1] == "layers.35.w_xz"
    assert leaves[("tail", "w_xz")].names == ("layers.36.w_xz",
                                              "layers.37.w_xz")


def test_lm_from_params_takes_the_matmul_dtype():
    cfg = get_smoke(ARCH)
    lm = LM.from_params(cfg, init_params(cfg, device="cpu"))
    assert lm.dtype == torch.bfloat16
    assert lm.layers[0].w_xz.dtype == torch.bfloat16
    assert lm.layers[0].D.dtype == torch.float32


# -- the serving engine against JAX --------------------------------------------

ENGINE_KW = dict(n_slots=3, n_fifo=2, max_len=48, initial_limit_ms=12.0)


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, cfg, jparams, _, p32, _ = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (1, n)) for n in (6, 17, 9, 20, 3)]
    with f32_compute():
        jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
        for rid, pr in enumerate(prompts):
            jeng.submit(JaxRequest(rid=rid, arrival_ms=0.0,
                                   tokens=jnp.asarray(pr, jnp.int32),
                                   max_new=3 + rid * 3))
        jdone = jeng.run()
    eng = ServingEngine(cfg, p32, device="cpu", **ENGINE_KW)
    for rid, pr in enumerate(prompts):
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0,
                               tokens=torch.from_numpy(pr),
                               max_new=3 + rid * 3))
    done = eng.run()
    return jeng, jdone, eng, done


def test_engine_tokens_identical(engines):
    _, jdone, _, done = engines
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for a, b in zip(done, jdone):
        assert len(a.generated) == 3 + a.rid * 3
        assert a.generated == b.generated


def test_engine_preemptions_identical(engines):
    _, jdone, _, done = engines
    assert [r.preemptions for r in done] == [r.preemptions for r in jdone]
    assert sum(r.preemptions for r in done) >= 1


def test_engine_completion_ms_and_cost_identical(engines):
    jeng, jdone, eng, done = engines
    assert [r.completion_ms for r in done] == [r.completion_ms for r in jdone]
    assert [r.first_run_ms for r in done] == [r.first_run_ms for r in jdone]
    assert [r.cost_usd() for r in done] == [r.cost_usd() for r in jdone]
    assert list(eng.adapter.window) == list(jeng.adapter.window)
    assert eng.now_ms == jeng.now_ms


# -- entry points ----------------------------------------------------------------

def test_serve_cli_engine_mode_on_cpu():
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--mode", "engine", "--device", "cpu"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 8
    for rid, line in enumerate(lines):
        assert line.startswith(f"req {rid}: tokens={4 + 2 * rid} ")


@pytest.mark.parametrize("entry", ["ServingEngine", "LM", "init_params"])
def test_entry_points_raise_without_cuda(entry):
    """The default device is the card; without one the entry points raise
    unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke(ARCH)
    calls = {
        "ServingEngine": lambda: ServingEngine(
            cfg, init_params(cfg, device="cpu")),
        "LM": lambda: LM(cfg),
        "init_params": lambda: init_params(cfg),
    }
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        calls[entry]()


def test_path_check_depth_cut_keeps_the_first_group(setup):
    """launch.path_check.depth_cut: the first group of SSM layers and the
    shared block, on the same weights; its path runs on the CPU (where
    both namespaces are the plain versions, so the distance is 0)."""
    from repro_torch.launch import path_check
    _, cfg, _, _, p32, _ = setup
    cut, sub = path_check.depth_cut(cfg, p32, 3)
    assert cut.n_layers == 3 and zamba_groups(cut) == (1, 0)
    assert {n.split(".")[1] for n in sub if n.startswith("layers.")} == \
        {"0", "1", "2"}
    assert all(sub[n] is p32[n] for n in sub)
    assert "shared_attn.wq" in sub and "shared_mlp.w_up" in sub
    assert path_check.depth_cut(cfg, p32, cfg.n_layers) == (cfg, p32)
    toks = path_check.prompt(cut, "cpu")
    a = path_check.path_logits(cut, sub, ops, toks)
    b = path_check.path_logits(cut, sub, plain, toks)
    assert len(a) == 1 + path_check.STEPS
    assert all(path_check.rel_dist(x, y) == 0.0 for x, y in zip(a, b))
