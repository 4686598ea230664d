"""The port's ``local_global`` family (gemma3) against the JAX model, on
the gemma3-12b smoke (7 layers: one group of 5 local + 1 global, and a
local tail layer) and the gemma3-27b smoke (13 layers: two groups and a
tail), window 16.

Both run in f32 compute on the same weights (the bridge) and the same
inputs, at the model tolerance of test_models.py (2e-3). A local layer's
cache is a ring of W slots holding position p at slot p % W. JAX's
prefill (``clip_window``, ``src/repro/models/transformer.py:346``)
stores the last W keys at slots 0..W-1, which is that layout only when
the prompt has at most W tokens or a multiple of W; its decode then
writes slot pos % W and labels the slots with ``_ring_positions``. So
the port is held against JAX's ``prefill`` / ``decode_step`` and JAX's
engine on such prompts, and against JAX's ``logits_train`` (the model's
definition) on the others.
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
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.models.layers import set_compute_dtype  # noqa: E402
from repro.serving import LiveRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.transformer import (lg_groups,  # noqa: E402
                                            lg_layers)
from repro_torch.params import (from_jax_numpy, init_params,  # noqa: E402
                                jax_leaves)
from repro_torch.serving import LiveRequest, ServingEngine  # noqa: E402
from repro_torch.serving.graphs import SlotDecoder  # noqa: E402

ARCHS = ("gemma3-12b", "gemma3-27b")
TOL = dict(rtol=2e-3, atol=2e-3)            # test_models.py:61
W = 16                                       # the smokes' local_window
STEPS = 4
ENGINE_KW = dict(n_slots=4, n_fifo=2, max_len=48, initial_limit_ms=12.0)


class f32_compute:
    """JAX's model in f32 compute, restored to bf16 on exit."""

    def __enter__(self):
        set_compute_dtype(jnp.float32)

    def __exit__(self, *exc):
        set_compute_dtype(jnp.bfloat16)


def tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """(arch, JAX config, JAX params, numpy tree, the port's f32 LM, the
    token rows and JAX's f32 logits_train of them)."""
    arch = request.param
    jcfg = jax_get_smoke(arch)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    lm = LM.from_params(get_smoke(arch),
                        from_jax_numpy(tree, get_smoke(arch), "cpu",
                                       torch.float32))
    toks = tokens((2, 32 + STEPS))
    with f32_compute():
        full = np.asarray(JaxLM(jcfg).logits_train(jparams,
                                                   jnp.asarray(toks)))
    return arch, jcfg, jparams, tree, lm, toks, full


def close_to_scale(a, b, tol=2e-3):
    """Caches: max |a - b| within tol of max |b| (keys deep in the stack
    reach |k| ~ 50 in f32, where rounding is relative to the scale)."""
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def port_steps(lm, toks, S):
    """The port's prefill of toks[:, :S] and STEPS teacher-forced decode
    steps: (logits (B, V) a step, the cache after them)."""
    B = toks.shape[0]
    with torch.inference_mode():
        logits, cache = lm.prefill(torch.from_numpy(toks[:, :S]), 48)
        out = [logits[:, 0].numpy()]
        for i in range(STEPS):
            logits, cache = lm.decode_step(
                torch.from_numpy(toks[:, S + i]), cache,
                torch.full((B,), S + i))
            out.append(logits[:, 0].numpy())
    return out, cache


def jax_steps(jcfg, jparams, toks, S):
    """JAX's prefill and STEPS decode steps on the same tokens."""
    B = toks.shape[0]
    lm = JaxLM(jcfg)
    with f32_compute():
        logits, cache = lm.prefill(jparams, jnp.asarray(toks[:, :S]), 48)
        out = [np.asarray(logits)[:, 0]]
        prefill_cache = cache
        for i in range(STEPS):
            logits, cache = lm.decode_step(
                jparams, jnp.asarray(toks[:, S + i], jnp.int32), cache,
                jnp.full((B,), S + i, jnp.int32))
            out.append(np.asarray(logits)[:, 0])
    return out, prefill_cache


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch):
    assert asdict(get_config(arch)) == asdict(jax_get_config(arch))
    assert asdict(get_smoke(arch)) == asdict(jax_get_smoke(arch))


def test_layer_order_matches_jax_groups(setup):
    """Layer g (R + 1) + R is the global one of group g, the tail local."""
    arch, jcfg, *_ = setup
    cfg = get_smoke(arch)
    G, tail = lg_groups(cfg)
    assert (G, tail) == {"gemma3-12b": (1, 1), "gemma3-27b": (2, 1)}[arch]
    glob = [i for i, (g, _) in enumerate(lg_layers(cfg)) if g]
    assert glob == [5 + 6 * g for g in range(G)]
    assert [j for g, j in lg_layers(cfg) if not g] == \
        list(range(cfg.n_layers - G))
    full = lg_layers(get_config("gemma3-12b"))
    assert [i for i, (g, _) in enumerate(full) if g] == list(range(5, 48, 6))


def test_logits_train_matches_jax(setup):
    *_, lm, toks, full = setup
    out = lm.logits_train(torch.from_numpy(toks)).numpy()
    assert out.shape == full.shape
    np.testing.assert_allclose(out, full, **TOL)


@pytest.mark.parametrize("S", [12, 16, 32])
def test_prefill_and_decode_match_jax(setup, S):
    """Prompts where JAX's window cache is ring-aligned (S <= W or a
    multiple of W): the port's prefill and 4 decode steps (at S 12 and
    16 they wrap the ring) against JAX's prefill / decode_step, and both
    against logits_train; the port's rings equal JAX's window caches."""
    arch, jcfg, jparams, _, lm, toks, full = setup
    mine, cache = port_steps(lm, toks, S)
    ref, jcache = jax_steps(jcfg, jparams, toks, S)
    for i, (a, b) in enumerate(zip(mine, ref, strict=True)):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, full[:, S - 1 + i], **TOL)
    with torch.inference_mode():
        _, cache = lm.prefill(torch.from_numpy(toks[:, :S]), 48)
    for name in ("k", "v"):
        rings = [np.asarray(jcache["local"][name]).reshape(
            (-1,) + jcache["local"][name].shape[2:])]
        if "tail" in jcache:
            rings.append(np.asarray(jcache["tail"][name]))
        close_to_scale(cache[f"{name}_win"].numpy(), np.concatenate(rings))
        close_to_scale(cache[name].numpy(), np.asarray(jcache["global"][name]))


def test_decode_after_a_prompt_off_the_ring_matches_logits_train(setup):
    """A prompt of 20 tokens (> W = 16, not a multiple): the port's prefill
    and decode against JAX's logits_train. JAX's own decode misses here:
    ``clip_window`` (src/repro/models/transformer.py:346) puts position
    4 + j at slot j, where its decode_step expects slot (4 + j) % 16, so
    its first step overwrites a key still in the window."""
    arch, jcfg, jparams, _, lm, toks, full = setup
    mine, cache = port_steps(lm, toks, 20)
    for i, a in enumerate(mine):
        np.testing.assert_allclose(a, full[:, 19 + i], **TOL)
    # the ring after 4 steps (positions 8..23) holds position p at p % W
    with torch.inference_mode():
        _, twin = lm.prefill(torch.from_numpy(toks[:, :24]), 48)
    close_to_scale(cache["k_win"].numpy(), twin["k_win"].numpy(), 1e-4)
    ref, _ = jax_steps(jcfg, jparams, toks, 20)
    assert np.abs(ref[1] - full[:, 20]).max() > 1e-2    # the reference's miss


def test_new_cache_holds_global_layers_linear_and_local_rings():
    cfg = get_smoke("gemma3-27b")
    lm = LM(cfg, device="meta", dtype=torch.float32)
    for max_len, ring in ((48, W), (10, 10)):
        cache = lm.new_cache(3, max_len, device="meta")
        assert tuple(cache["k"].shape) == (2, 3, 2, max_len, 16)
        assert tuple(cache["v_win"].shape) == (11, 3, 2, ring, 16)
        assert set(cache) == {"k", "v", "k_win", "v_win"}


def test_lm_refuses_local_global_without_a_window():
    cfg = get_smoke("gemma3-12b").with_(local_window=0)
    with pytest.raises(ValueError, match="local_window"):
        LM(cfg, device="meta")


# -- parameters ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_jax_leaves_match_materialize_specs(arch):
    """Paths, shapes and stds of the full-width tree against JAX's
    ParamSpecs (fan_in: the first stacked axis, G for blocks, tail for
    tail), and the layer each slice lands on."""
    cfg = get_config(arch)
    specs = model_specs(jax_get_config(arch))
    leaves = jax_leaves(cfg)
    n = 0
    for path, leaf in leaves.items():
        spec = specs
        for k in path:
            spec = spec[k]
        assert is_spec(spec) and spec.shape == leaf.shape, path
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
        if spec.init == "zeros":
            assert leaf.init == "zeros"
        else:
            assert leaf.std == pytest.approx(spec.scale / np.sqrt(fan_in))
        n += 1
    assert n == len(jax.tree.leaves(specs, is_leaf=is_spec))
    G, tail = lg_groups(cfg)
    assert (G, tail) == {"gemma3-12b": (8, 0), "gemma3-27b": (10, 2)}[arch]
    assert leaves[("blocks", "local", "wq")].std == pytest.approx(
        1 / np.sqrt(G))
    names = {n for leaf in leaves.values() for n in leaf.names}
    assert names == {n for n, _ in LM(cfg, device="meta").named_parameters()}
    assert leaves[("blocks", "global", "attn", "wq")].names[1] == \
        "layers.11.attn.wq"
    assert leaves[("blocks", "local", "wq")].names[5] == "layers.6.attn.wq"
    if tail:
        assert leaves[("tail", "mlp", "w_up")].std == pytest.approx(
            1 / np.sqrt(tail))
        assert leaves[("tail", "attn", "wq")].names == tuple(
            f"layers.{6 * G + t}.attn.wq" for t in range(tail))


def test_bridge_puts_each_slice_on_its_layer(setup):
    arch, jcfg, _, tree, *_ = setup
    cfg = get_smoke(arch)
    p = from_jax_numpy(tree, cfg, "cpu", torch.float32)
    G, _ = lg_groups(cfg)
    for g in range(G):
        for r in range(5):
            np.testing.assert_array_equal(
                p[f"layers.{6 * g + r}.attn.wk"].numpy(),
                tree["blocks"]["local"]["wk"][g, r])
            np.testing.assert_array_equal(
                p[f"layers.{6 * g + r}.mlp.w_up"].numpy(),
                tree["blocks"]["local_mlp"]["w_up"][g, r])
        np.testing.assert_array_equal(
            p[f"layers.{6 * g + 5}.attn.wo"].numpy(),
            tree["blocks"]["global"]["attn"]["wo"][g])
    np.testing.assert_array_equal(p[f"layers.{6 * G}.mlp.w_down"].numpy(),
                                  tree["tail"]["mlp"]["w_down"][0])
    assert len(p) == 2 + cfg.n_layers * 9


def test_init_params_std_matches_materialize(setup):
    """The on-device initialiser draws each stacked leaf with
    materialize's std (fan_in = G for the groups' leaves)."""
    arch, _, _, tree, *_ = setup
    cfg = get_smoke(arch)
    p = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    G, _ = lg_groups(cfg)
    for leaf in ("wq", "wv"):
        mine = np.stack([p[f"layers.{6 * g + r}.attn.{leaf}"].numpy()
                         for g in range(G) for r in range(5)])
        ref = tree["blocks"]["local"][leaf]
        np.testing.assert_allclose(mine.std(), ref.std(), rtol=0.1)
        np.testing.assert_allclose(mine.std(), 1 / np.sqrt(G), rtol=0.1)
    assert not p["layers.5.attn.norm"].any()


# -- serving -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """Both engines on the gemma3-12b smoke, prompts of at most W tokens or
    a multiple of W (JAX's ring is then aligned); decode runs past W."""
    arch = "gemma3-12b"
    jcfg = jax_get_smoke(arch)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    p32 = from_jax_numpy(jax.tree.map(np.asarray, jparams), get_smoke(arch),
                         "cpu", torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (1, n))
               for n in (6, 16, 9, 12, 3, 32)]
    with f32_compute():
        jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
        for rid, p in enumerate(prompts):
            jeng.submit(JaxRequest(rid=rid, arrival_ms=0.0,
                                   tokens=jnp.asarray(p, jnp.int32),
                                   max_new=3 + rid * 3 - (rid == 5) * 3))
        jdone = jeng.run()
    eng = ServingEngine(get_smoke(arch), p32, device="cpu", **ENGINE_KW)
    for rid, p in enumerate(prompts):
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0,
                               tokens=torch.from_numpy(p),
                               max_new=3 + rid * 3 - (rid == 5) * 3))
    return jdone, eng.run(), jeng, eng, p32


def test_engine_matches_jax_engine(engines):
    jdone, done, jeng, eng, _ = engines
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for a, b in zip(done, jdone):
        assert a.generated == b.generated
    assert max(r.tokens.shape[1] + len(r.generated) for r in done) > W + 1
    assert [r.preemptions for r in done] == [r.preemptions for r in jdone]
    assert sum(r.preemptions for r in done) >= 2
    assert [r.completion_ms for r in done] == [r.completion_ms for r in jdone]
    assert [r.cost_usd() for r in done] == [r.cost_usd() for r in jdone]
    assert list(eng.adapter.window) == list(jeng.adapter.window)
    assert eng.now_ms == jeng.now_ms


def test_engine_off_the_ring_matches_teacher_forced_logits_train(engines):
    """Prompts longer than W and not a multiple of it (where JAX's engine
    inherits clip_window's misalignment): each request's tokens are the
    greedy choices of logits_train over its prompt and the tokens before."""
    *_, p32 = engines
    cfg = get_smoke("gemma3-12b")
    lm = LM.from_params(cfg, p32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (1, n)) for n in (20, 25, 17, 30)]
    eng = ServingEngine(cfg, p32, device="cpu", **ENGINE_KW)
    for rid, p in enumerate(prompts):
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0,
                               tokens=torch.from_numpy(p), max_new=6 + rid))
    done = eng.run()
    assert sum(r.preemptions for r in done) >= 1
    for r in done:
        S = r.tokens.shape[1]
        seq = torch.cat([r.tokens, torch.tensor([r.generated[:-1]])], 1)
        with torch.inference_mode():
            greedy = lm.logits_train(seq)[0, S - 1:].argmax(-1).tolist()
        assert greedy == r.generated, r.rid


def test_swap_across_the_wrap_keeps_the_logits_bitwise():
    """A request leaves slot 0 with its ring about to wrap, the slot is
    reused, and the request comes back in slot 1 and decodes past the
    wrap point exactly as a twin that kept its own cache."""
    cfg = get_smoke("gemma3-12b")
    lm = LM.from_params(cfg, init_params(cfg, seed=0, device="cpu",
                                         dtype=torch.float32))
    dec = SlotDecoder(lm, n_slots=2, max_len=40)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 13)))
    other = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 21)))
    with torch.inference_mode():
        logits, twin = lm.prefill(prompt, 40)
        assert torch.equal(dec.prefill(0, prompt), logits)
        tok, slot = int(logits[0, -1].argmax()), 0
        for pos in range(13, 24):
            if pos == 15:
                saved = dec.save(0)
                dec.prefill(0, other)              # the slot is reused
                dec.step(0, 7, 21)
                dec.load(1, saved)
                slot = 1
            got = dec.step(slot, tok, pos).clone()
            want, twin = lm.decode_step(torch.tensor([tok]), twin,
                                        torch.tensor([pos]))
            assert torch.equal(got, want), f"step at {pos} in slot {slot}"
            tok = int(want[0, -1].argmax())
    for name, t in dec.caches[1].items():
        assert torch.equal(t, twin[name]), name


def test_prefill_into_a_used_cache_equals_a_fresh_one():
    """A used slot (a 20-token prompt wrapped its rings) prefilled with a
    7-token prompt: rings and linear caches equal a fresh prefill's."""
    cfg = get_smoke("gemma3-12b")
    lm = LM.from_params(cfg, init_params(cfg, seed=0, device="cpu",
                                         dtype=torch.float32))
    rng = np.random.default_rng(6)
    long, short = (torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)))
                   for n in (20, 7))
    with torch.inference_mode():
        _, used = lm.prefill(long, 24)
        lm.decode_step(torch.tensor([3]), used, torch.tensor([20]))
        logits, cache = lm.prefill(short, 24, cache=used)
        want_logits, want = lm.prefill(short, 24)
    assert cache is used
    assert torch.equal(logits, want_logits)
    for name in want:
        assert torch.equal(cache[name], want[name]), name


def test_serve_cli_serves_gemma3_on_cpu():
    """The serving entry point on the gemma3-12b smoke: 8 prompts of 8
    tokens and up to 18 new ones, so every ring of 16 slots wraps."""
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-12b", "--device", "cpu"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert [line.split(" exec")[0] for line in lines] == [
        f"req {rid}: tokens={4 + 2 * rid}" for rid in range(8)]
