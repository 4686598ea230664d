"""The port's rwkv path (repro_torch.models.rwkv, the rwkv branch of
repro_torch.models.transformer, repro_torch.kernels.rwkv6_scan) against
the JAX package on the rwkv6-1.6b smoke config (2 layers, d 64).

The plain rwkv6_scan is held against the JAX oracle and the Pallas kernel
in interpret mode (f32 2e-4, test_kernels.py:102); the layers, the LM and
the serving engine against the JAX model in f32 compute on the same
weights (the bridge) and the same inputs (model tolerance 2e-3,
test_models.py:61; engine decisions identical). JAX's time-mix takes its
chunked-parallel form when S is a multiple of 16 and its sequential form
otherwise; the port computes the recurrence step by step, so both kinds
of prompt length are checked.
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
from repro.kernels import rwkv6_scan as pallas_rwkv  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.serving import LiveRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ops, plain  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,  # noqa: E402
                                            rwkv6_scan_plain)
from repro_torch.models import LM, rwkv  # noqa: E402
from repro_torch.params import (from_jax_numpy, init_params,  # noqa: E402
                                jax_leaves)
from repro_torch.serving import LiveRequest, ServingEngine  # noqa: E402

ARCH = "rwkv6-1.6b"
TOL = dict(rtol=2e-3, atol=2e-3)            # test_models.py:61
KTOL = dict(rtol=2e-4, atol=2e-4)           # test_kernels.py:102


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


def jax_layer(tree, i: int) -> dict:
    return {k: jnp.asarray(v[i]) for k, v in tree["blocks"].items()}


def random_layer(p32, i: int, seed: int) -> dict:
    """Layer i's parameters with the zero-initialised leaves (mu_*, u,
    w_bias) drawn at random, so the token shift, the bonus and the decay
    bias are exercised; (torch layer, JAX layer)."""
    rng = np.random.default_rng(seed)
    cfg = get_smoke(ARCH)
    lm = LM.from_params(cfg, {k: v.clone() for k, v in p32.items()})
    layer = lm.layers[i]
    with torch.no_grad():
        for name, t in layer.named_parameters():
            if name.startswith("mu_"):
                t.copy_(torch.from_numpy(rng.uniform(0, 1, t.shape)
                                         .astype(np.float32)))
            elif name in ("u", "w_bias"):
                t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.5)
                                         .astype(np.float32)))
    jp = {n: jnp.asarray(t.numpy()) for n, t in layer.named_parameters()}
    return layer, jp


def tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


def scan_inputs(rng, bh, s, hd, n_u=None):
    """r, k, v, w, u as numpy f32 (test_kernels.py:92's scales)."""
    r, k, v = ((rng.standard_normal((bh, s, hd)) * 0.3).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((bh, s, hd))))) \
        .astype(np.float32)
    u = (rng.standard_normal((n_u or bh, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def test_config_copy_matches_jax():
    assert asdict(get_config(ARCH)) == asdict(jax_get_config(ARCH))
    assert asdict(get_smoke(ARCH)) == asdict(jax_get_smoke(ARCH))
    assert rwkv.rwkv_dims(get_config(ARCH)) == \
        jrwkv.rwkv_dims(jax_get_config(ARCH)) == (32, 64)
    assert rwkv.LOGW_MIN == jrwkv._LOGW_MIN


# -- the plain scan against the oracle and the Pallas kernel ---------------

@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("s,hd", [(128, 64), (96, 32)])
def test_rwkv6_scan_plain_matches_ref_and_pallas(chunk, s, hd):
    rng = np.random.default_rng(chunk + s + hd)
    arrs = scan_inputs(rng, 2, s, hd)
    o, st = rwkv6_scan_plain(*map(torch.from_numpy, arrs))
    exp = ref.rwkv6_scan_ref(*map(jnp.asarray, arrs))
    pal = pallas_rwkv(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    assert o.dtype == torch.float32 and tuple(st.shape) == (2, hd, hd)
    np.testing.assert_allclose(o.numpy(), np.asarray(exp), **KTOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(pal), **KTOL)


@pytest.mark.parametrize("s", [1, 37])
def test_rwkv6_scan_plain_any_length(s):
    """Any S, no chunk multiple needed; the final state is the JAX
    sequential form's."""
    rng = np.random.default_rng(s)
    r, k, v, w, u = scan_inputs(rng, 2, s, 64)
    o, st = rwkv6_scan_plain(*map(torch.from_numpy, (r, k, v, w, u)))
    exp = ref.rwkv6_scan_ref(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(exp), **KTOL)
    to_h = (lambda a: jnp.asarray(a)[:, :, None, :])        # (BH, S, 1, hd)
    s_fin, _ = jrwkv._time_mix_sequential(
        {"u": jnp.asarray(u[0])[None]}, to_h(r[:1]), to_h(k[:1]),
        to_h(v[:1]), to_h(np.log(w[:1])), jnp.zeros((1, 1, 64, 64)))
    np.testing.assert_allclose(st[:1].numpy(), np.asarray(s_fin)[:, 0],
                               **KTOL)


def test_rwkv6_scan_plain_shared_u_rows():
    """Row bh reads u row bh % NU: the same as tiling u over the batch."""
    rng = np.random.default_rng(4)
    r, k, v, w, u = scan_inputs(rng, 4, 24, 32, n_u=2)
    o, st = rwkv6_scan_plain(*map(torch.from_numpy, (r, k, v, w, u)))
    ot, stt = rwkv6_scan_plain(*map(torch.from_numpy,
                                    (r, k, v, w, np.tile(u, (2, 1)))))
    exp = ref.rwkv6_scan_ref(*map(jnp.asarray,
                                  (r, k, v, w, np.tile(u, (2, 1)))))
    np.testing.assert_allclose(o.numpy(), np.asarray(exp), **KTOL)
    assert torch.equal(o, ot) and torch.equal(st, stt)


def test_ops_rwkv6_scan_dispatches_cpu_to_plain_without_counting():
    rng = np.random.default_rng(5)
    args = list(map(torch.from_numpy, scan_inputs(rng, 2, 20, 16)))
    ops.reset_launch_counts()
    o, st = ops.rwkv6_scan(*args)
    op, stp = plain.rwkv6_scan(*args)
    assert torch.equal(o, op) and torch.equal(st, stp)
    assert ops.launch_counts()["rwkv6_scan"] == 0


def test_rwkv6_scan_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(6)
    args = list(map(torch.from_numpy, scan_inputs(rng, 2, 20, 16)))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        rwkv6_scan_cuda(*args)
    assert ops.launch_counts()["rwkv6_scan"] == 0


# -- the layer against JAX ---------------------------------------------------

@pytest.mark.parametrize("S", [32, 21])
def test_rwkv_time_mix_matches_jax(setup, S):
    """Prefill from the zero state: output and the new state. JAX takes
    its chunked form at S = 32 and its sequential form at S = 21."""
    jcfg, _, _, _, p32, _ = setup
    layer, jp = random_layer(p32, 1, seed=S)
    cfg = get_smoke(ARCH)
    x = np.random.default_rng(S).standard_normal((2, S, 64), np.float32)
    with f32_compute():
        jout, jst = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), jcfg,
                                        jrwkv.rwkv_init_state(jcfg, 2))
    out, st = rwkv.rwkv_time_mix(layer, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in ("S", "x_tm"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]),
                                   **TOL)


@pytest.mark.parametrize("S", [16, 1])
def test_rwkv_block_matches_jax(setup, S):
    """rwkv_block from the zero state (S = 16: chunked in JAX, one token:
    sequential), then one decode step from the state it returned."""
    jcfg, _, _, _, p32, _ = setup
    layer, jp = random_layer(p32, 0, seed=S + 100)
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, 64), np.float32)
    x1 = rng.standard_normal((2, 1, 64), np.float32)
    with f32_compute():
        jout, jst = jrwkv.rwkv_block(jp, jnp.asarray(x), jcfg)
        jout1, jst1 = jrwkv.rwkv_block(jp, jnp.asarray(x1), jcfg, state=jst)
    out, st = rwkv.rwkv_block(layer, torch.from_numpy(x), cfg)
    out1, st1 = rwkv.rwkv_block(layer, torch.from_numpy(x1), cfg, st)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(out1.numpy(), np.asarray(jout1), **TOL)
    for name in ("S", "x_tm", "x_cm"):
        np.testing.assert_allclose(st1[name].numpy(), np.asarray(jst1[name]),
                                   **TOL)


def test_rwkv_step_refuses_a_sequence_from_a_state(setup):
    _, cfg, _, _, _, lm = setup
    state = rwkv.rwkv_init_state(cfg, 1, "cpu")
    with pytest.raises(ValueError, match="one token"):
        rwkv.rwkv_block(lm.layers[0], torch.zeros(1, 3, 64), cfg, state)


def test_rwkv_init_state_matches_jax():
    cfg = get_smoke(ARCH)
    st = rwkv.rwkv_init_state(cfg, 3, "cpu")
    exp = jrwkv.rwkv_init_state(jax_get_smoke(ARCH), 3)
    assert set(st) == set(exp)
    for name, t in st.items():
        assert tuple(t.shape) == exp[name].shape and not t.any()


# -- the LM against JAX --------------------------------------------------------

@pytest.mark.parametrize("S", [24, 32])
def test_logits_train_matches_jax(setup, S):
    jcfg, _, jparams, _, _, lm = setup
    toks = tokens((2, S))
    with f32_compute():
        exp = JaxLM(jcfg).logits_train(jparams, jnp.asarray(toks))
    out = lm.logits_train(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and tuple(out.shape) == exp.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("S", [32, 21])
def test_prefill_and_decode_steps_match_jax(setup, S):
    """Prefill + 4 decode steps, logits and the cache (S, x_tm, x_cm as
    JAX's (L, B, ...) trees), for a prompt length that is a multiple of 16
    (JAX chunked) and one that is not (JAX sequential)."""
    jcfg, _, jparams, _, _, lm = setup
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
    for name in ("S", "x_tm", "x_cm"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_prefill_decode_consistency(setup):
    """Teacher-forced decode reproduces the parallel logits (port only)."""
    _, _, _, _, _, lm = setup
    B, S, extra = 2, 19, 4
    toks = torch.from_numpy(tokens((B, S + extra), seed=9))
    full = lm.logits_train(toks)
    logits, cache = lm.prefill(toks[:, :S], max_len=S + extra)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    for i in range(extra):
        d, cache = lm.decode_step(toks[:, S + i], cache,
                                  torch.full((B,), S + i))
        torch.testing.assert_close(d[:, 0], full[:, S + i], **TOL)


# -- parameters ----------------------------------------------------------------

def test_bridge_unstacks_layers(setup):
    _, cfg, _, tree, _, _ = setup
    p = from_jax_numpy(tree, cfg, "cpu", torch.bfloat16)
    assert len(p) == 3 + cfg.n_layers * 20
    for name in ("layers.0.w_r", "layers.1.w_o", "layers.1.wd_a",
                 "layers.0.wd_b", "layers.1.w_ck", "layers.0.w_cv"):
        assert p[name].dtype == torch.bfloat16, name
    for name in ("layers.0.u", "layers.0.mu_r", "layers.1.w_bias",
                 "layers.1.o_norm", "embed", "lm_head"):
        assert p[name].dtype == torch.float32, name
    np.testing.assert_array_equal(
        p["layers.1.w_k"].float().numpy(),
        np.asarray(jnp.asarray(tree["blocks"]["w_k"][1])
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(p["lm_head"].numpy(), tree["lm_head"])


def test_init_params_std_matches_materialize(setup):
    """Leaf by leaf, the on-device initialiser draws with materialize's
    std, fan_in = the layer count for every stacked leaf."""
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
        np.testing.assert_allclose(mine.std(), ref_leaf.std(), rtol=0.1)
        np.testing.assert_allclose(mine.std(), leaf.std, rtol=0.1)
        checked += 1
    assert checked == 9 + 2


def test_init_std_rule_at_full_width():
    """The full-width spec table against the JAX ParamSpecs (no arrays):
    std 1/sqrt(24) for the stacked projections, (1/sqrt(48))/sqrt(24) for
    w_o and w_cv."""
    cfg = get_config(ARCH)
    specs = model_specs(jax_get_config(ARCH))
    leaves = jax_leaves(cfg)
    assert len(leaves) == 3 + 20
    for path, leaf in leaves.items():
        spec = specs
        for k in path:
            spec = spec[k]
        assert is_spec(spec) and spec.shape == leaf.shape, path
        assert spec.init == leaf.init, path
        if spec.init == "normal":
            assert leaf.std == pytest.approx(spec.scale
                                             / np.sqrt(spec.shape[0]))
    assert leaves[("blocks", "w_r")].std == pytest.approx(1 / np.sqrt(24))
    assert leaves[("blocks", "w_cv")].std == pytest.approx(
        1 / np.sqrt(48) / np.sqrt(24))
    assert leaves[("lm_head",)].std == pytest.approx(1 / np.sqrt(2048))


# -- the serving engine against JAX --------------------------------------------

ENGINE_KW = dict(n_slots=3, n_fifo=2, max_len=48, initial_limit_ms=10.0)


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, cfg, jparams, _, p32, _ = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (1, n))
               for n in (6, 16, 9, 32, 3)]
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
