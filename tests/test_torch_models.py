"""The port's model (repro_torch.models, repro_torch.params) against the
JAX model on the deepseek-7b smoke config, and on the qwen2-vl-2b (M-RoPE,
GQA, tied head) and musicgen-large (MHA, untied head) smokes.

Parity tests run both in f32 compute with the same weights (the bridge)
and the same inputs, at the model tolerance of test_models.py (2e-3).
"""
from dataclasses import asdict

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
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, get_smoke  # noqa: E402
from repro_torch.models import LM, layers  # noqa: E402
from repro_torch.params import (from_jax_numpy, init_params,  # noqa: E402
                                jax_leaves)

ARCH = "deepseek-7b"
TOL = dict(rtol=2e-3, atol=2e-3)            # test_models.py:61


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


def layer0(tree, sub):
    return {k: jnp.asarray(v[0]) for k, v in tree["blocks"][sub].items()}


def tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


def test_config_copy_matches_jax():
    assert asdict(get_config(ARCH)) == asdict(jax_get_config(ARCH))
    assert asdict(get_smoke(ARCH)) == asdict(jax_get_smoke(ARCH))


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    w = rng.standard_normal(64, np.float32) * 0.1
    out = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    exp = jl.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=2e-5,
                               atol=2e-5)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 16), np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 100])       # (B, S)
    out = layers.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(pos)[:, None])
    exp = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos)[:, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-4,
                               atol=1e-4)


def test_qkv_matches_jax(setup):
    jcfg, cfg, _, tree, _, lm = setup
    x = np.random.default_rng(2).standard_normal((2, 7, 64), np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    with f32_compute():
        jq, jk, jv = jl._qkv(layer0(tree, "attn"), jnp.asarray(x), jcfg,
                             jnp.asarray(pos))
    q, k, v = layers._qkv(lm.layers[0].attn, torch.from_numpy(x), cfg,
                          torch.from_numpy(pos.copy()))
    for a, b in ((q, jq), (k, jk), (v, jv)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_attention_prefill_matches_jax(setup):
    jcfg, cfg, _, tree, _, lm = setup
    x = np.random.default_rng(4).standard_normal((2, 11, 64), np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    with f32_compute():
        jout, jkv = jl.attention(layer0(tree, "attn"), jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos),
                                 update_cache=True)
    out, kv = layers.attention(lm.layers[0].attn, torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos.copy()),
                               update_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]), **TOL)
    np.testing.assert_allclose(kv["v"].numpy(), np.asarray(jkv["v"]), **TOL)


def test_attention_decode_matches_jax(setup):
    """One decode step over a partly filled cache; the port writes the new
    k/v into its cache in place, JAX returns a new cache."""
    jcfg, cfg, _, tree, _, lm = setup
    rng = np.random.default_rng(5)
    B, S, KV, hd = 2, 16, cfg.n_kv_heads, cfg.hd
    pos = np.array([9, 3])
    kc = rng.standard_normal((B, KV, S, hd), np.float32)
    vc = rng.standard_normal((B, KV, S, hd), np.float32)
    for b, p in enumerate(pos):
        kc[b, :, p:] = 0.0
        vc[b, :, p:] = 0.0
    x = rng.standard_normal((B, 1, 64), np.float32)
    with f32_compute():
        jout, jcache = jl.attention(
            layer0(tree, "attn"), jnp.asarray(x), jcfg,
            positions=jnp.asarray(pos)[:, None],
            cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            cache_pos=jnp.asarray(pos))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, new = layers.attention(
        lm.layers[0].attn, torch.from_numpy(x), cfg,
        positions=torch.from_numpy(pos)[:, None], cache=cache,
        cache_pos=torch.from_numpy(pos))
    assert new["k"] is cache["k"]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)


def test_mlp_matches_jax(setup):
    jcfg, cfg, _, tree, _, lm = setup
    x = np.random.default_rng(6).standard_normal((2, 5, 64), np.float32)
    with f32_compute():
        exp = jl.mlp(layer0(tree, "mlp"), jnp.asarray(x), jcfg)
    out = layers.mlp(lm.layers[0].mlp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_logits_train_matches_jax(setup):
    jcfg, _, jparams, _, _, lm = setup
    toks = tokens((2, 24))
    with f32_compute():
        exp = JaxLM(jcfg).logits_train(jparams, jnp.asarray(toks))
    out = lm.logits_train(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and tuple(out.shape) == exp.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_prefill_and_decode_steps_match_jax(setup):
    jcfg, _, jparams, _, _, lm = setup
    B, S, extra = 2, 20, 4
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
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(jcache["body"]["k"]), **TOL)


def test_prefill_decode_consistency(setup):
    """Teacher-forced decode reproduces the parallel logits (port only;
    the test_models.py:45 check)."""
    _, _, _, _, _, lm = setup
    B, S, extra = 2, 32, 4
    toks = torch.from_numpy(tokens((B, S + extra), seed=9))
    full = lm.logits_train(toks)
    logits, cache = lm.prefill(toks[:, :S], max_len=S + extra)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    pos = torch.full((B,), S)
    for i in range(extra):
        d, cache = lm.decode_step(toks[:, S + i], cache, pos + i)
        torch.testing.assert_close(d[:, 0], full[:, S + i], **TOL)


def test_bf16_logits_parity(setup):
    """bf16 compute in both packages. They round in different places: the
    JAX model casts P to bf16 before P V and scales after the bf16 Q K^T,
    the port keeps P in f32 and scales q in f32 (the Pallas kernel's
    order), and bf16 matmuls round differently in XLA and PyTorch. The
    logits are f32 but every hidden state is bf16 (8 bits of mantissa,
    ~4e-3 relative), so the bound is 5e-2 of the logits' scale."""
    jcfg, cfg, jparams, tree, _, _ = setup
    lm = LM.from_params(cfg, from_jax_numpy(tree, cfg, "cpu",
                                            torch.bfloat16))
    toks = tokens((2, 24), seed=12)
    exp = np.asarray(JaxLM(jcfg).logits_train(jparams, jnp.asarray(toks)))
    out = lm.logits_train(torch.from_numpy(toks)).numpy()
    scale = np.abs(exp).max()
    assert np.abs(out - exp).max() <= 5e-2 * scale


def test_bridge_unstacks_layers_and_casts_matmuls(setup):
    _, cfg, _, tree, _, _ = setup
    p = from_jax_numpy(tree, cfg, "cpu", torch.bfloat16)
    assert p["layers.1.attn.wq"].dtype == torch.bfloat16
    assert p["layers.1.mlp.w_down"].dtype == torch.bfloat16
    for name in ("embed", "lm_head", "final_norm", "layers.0.attn.norm",
                 "layers.1.mlp.norm"):
        assert p[name].dtype == torch.float32, name
    np.testing.assert_array_equal(p["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(
        p["layers.1.mlp.w_gate"].float().numpy(),
        np.asarray(jnp.asarray(tree["blocks"]["mlp"]["w_gate"][1])
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    assert len(p) == 3 + cfg.n_layers * 9


def test_init_params_std_matches_materialize(setup):
    """Leaf by leaf, the on-device initialiser draws with materialize's
    std, including fan_in = layer count for the stacked per-layer leaves
    (std 1/sqrt(2) for wq at the smoke config's 2 layers)."""
    _, cfg, _, tree, _, _ = setup
    p = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    checked = 0
    for path in jax_leaves(cfg):
        ref_leaf = tree
        for k in path:
            ref_leaf = ref_leaf[k]
        if path[0] == "blocks":
            mine = np.stack([p[f"layers.{i}.{path[1]}.{path[2]}"].numpy()
                             for i in range(cfg.n_layers)])
        else:
            mine = p[path[0]].numpy()
        assert mine.shape == ref_leaf.shape
        if not ref_leaf.any():
            assert not mine.any(), path
            continue
        np.testing.assert_allclose(mine.std(), ref_leaf.std(), rtol=0.06)
        checked += 1
    assert checked == 9
    wq = np.stack([p[f"layers.{i}.attn.wq"].numpy() for i in range(2)])
    np.testing.assert_allclose(wq.std(), 1 / np.sqrt(2), rtol=0.03)


def test_init_std_rule_at_full_width():
    """The full-width spec table against the JAX ParamSpecs (no arrays):
    wq/wk/wv/w_gate/w_up std 1/sqrt(30), wo/w_down (1/sqrt(60))/sqrt(30)."""
    cfg = get_config(ARCH)
    specs = model_specs(jax_get_config(ARCH))
    leaves = jax_leaves(cfg)
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
    assert leaves[("blocks", "attn", "wq")].std == pytest.approx(
        1 / np.sqrt(30))
    assert leaves[("blocks", "mlp", "w_down")].std == pytest.approx(
        1 / np.sqrt(60) / np.sqrt(30))
    assert leaves[("embed",)].std == pytest.approx(1 / np.sqrt(102400))
    assert leaves[("lm_head",)].std == pytest.approx(1 / np.sqrt(4096))


def test_init_params_seeded():
    cfg = get_smoke(ARCH)
    a = init_params(cfg, seed=1, device="cpu")
    b = init_params(cfg, seed=1, device="cpu")
    c = init_params(cfg, seed=2, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attn.wq"], c["layers.0.attn.wq"])
    assert a["layers.0.attn.wq"].dtype == torch.bfloat16


# -- first_k_dense without experts: JAX's head_layers before its blocks ------


@pytest.fixture(scope="module")
def head_setup():
    """deepseek-7b's smoke with its first layer as a dense head layer
    (d_ff_head = d_ff: no experts): the JAX tree has ``head_layers``
    (fan_in 1) and a 1-layer ``blocks`` stack, the port one list."""
    jcfg = jax_get_smoke(ARCH).with_(first_k_dense=1)
    cfg = get_smoke(ARCH).with_(first_k_dense=1)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    assert set(tree) >= {"head_layers", "blocks"}
    p32 = from_jax_numpy(tree, cfg, "cpu", torch.float32)
    np.testing.assert_array_equal(p32["layers.0.mlp.w_up"].numpy(),
                                  tree["head_layers"]["mlp"]["w_up"][0])
    np.testing.assert_array_equal(p32["layers.1.attn.wq"].numpy(),
                                  tree["blocks"]["attn"]["wq"][0])
    return jcfg, jparams, LM.from_params(cfg, p32)


def test_first_k_dense_logits_train_matches_jax(head_setup):
    jcfg, jparams, lm = head_setup
    toks = tokens((2, 24), seed=14)
    with f32_compute():
        exp = JaxLM(jcfg).logits_train(jparams, jnp.asarray(toks))
    out = lm.logits_train(torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_first_k_dense_prefill_and_decode_match_jax(head_setup):
    jcfg, jparams, lm = head_setup
    B, S, extra = 2, 20, 4
    toks = tokens((B, S + extra), seed=15)
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
    np.testing.assert_allclose(cache["k"][0].numpy(),
                               np.asarray(jcache["head"]["k"][0]), **TOL)
    np.testing.assert_allclose(cache["k"][1].numpy(),
                               np.asarray(jcache["body"]["k"][0]), **TOL)


# -- qwen2-vl-2b and musicgen-large -------------------------------------------

MODAL = ("qwen2-vl-2b", "musicgen-large")
_MODAL = {}


def modal_setup(arch):
    """(JAX config, JAX params, numpy tree, port f32 LM) of the smoke."""
    if arch not in _MODAL:
        jcfg = jax_get_smoke(arch)
        jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        cfg = get_smoke(arch)
        _MODAL[arch] = jcfg, jparams, tree, LM.from_params(
            cfg, from_jax_numpy(tree, cfg, "cpu", torch.float32))
    return _MODAL[arch]


@pytest.mark.parametrize("arch", MODAL)
def test_modal_config_copy_matches_jax(arch):
    assert asdict(get_config(arch)) == asdict(jax_get_config(arch))
    assert asdict(get_smoke(arch)) == asdict(jax_get_smoke(arch))
    LM(get_config(arch), device="meta")          # builds at full size


@pytest.mark.parametrize("arch", MODAL)
def test_modal_leaves_cover_the_jax_tree(arch):
    """``jax_leaves`` at full width has the JAX specs' paths and shapes
    (qwen2-vl's tied head: no ``lm_head``), and the bridge and the
    initialiser give exactly the LM's parameters."""
    cfg = get_config(arch)
    specs = model_specs(jax_get_config(arch))
    leaves = jax_leaves(cfg)
    flat = {}

    def walk(node, path):
        if is_spec(node):
            flat[path] = node.shape
        else:
            for k, v in node.items():
                walk(v, path + (k,))

    walk(specs, ())
    assert {p: leaf.shape for p, leaf in leaves.items()} == flat
    assert (("lm_head",) in leaves) == (not cfg.tie_embeddings)
    _, _, tree, lm = modal_setup(arch)
    smoke = get_smoke(arch)
    names = {n: (tuple(p.shape), p.dtype) for n, p in lm.named_parameters()}
    p16 = from_jax_numpy(tree, smoke, "cpu", torch.bfloat16)
    init = init_params(smoke, seed=0, device="cpu")
    for params in (p16, init):
        assert {n: (tuple(t.shape), t.dtype if t.dtype == torch.float32
                    else torch.float32) for n, t in params.items()} == names
    assert p16["layers.0.attn.wq"].dtype == torch.bfloat16
    assert init["layers.1.mlp.w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", MODAL)
def test_modal_logits_train_matches_jax(arch):
    jcfg, jparams, _, lm = modal_setup(arch)
    toks = np.random.default_rng(16).integers(0, jcfg.vocab, (2, 24))
    with f32_compute():
        exp = JaxLM(jcfg).logits_train(jparams, jnp.asarray(toks))
    out = lm.logits_train(torch.from_numpy(toks))
    assert tuple(out.shape) == exp.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("arch", MODAL)
def test_modal_prefill_and_decode_steps_match_jax(arch):
    jcfg, jparams, _, lm = modal_setup(arch)
    B, S, extra = 2, 20, 4
    toks = np.random.default_rng(17).integers(0, jcfg.vocab, (B, S + extra))
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
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(jcache["body"]["k"]), **TOL)
