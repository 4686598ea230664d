"""The port's M-RoPE and modality frontends (repro_torch.models.layers,
repro_torch.models.frontends, ``LM.prefill(embeds=)``) against the JAX
package, on numpy inputs from a seed.

The JAX model never feeds M-RoPE three distinct position streams: its
prefill and decode positions are 2-D and ``_qkv`` broadcasts them, where
``apply_mrope`` equals ``apply_rope``. So the section mapping is held
here, at the layer, with the distinct streams of ``mrope_positions``:
f32 at 2e-5 (``tests/test_kernels.py:23``; the attention sublayer's
outputs, of scale ~50 under the smoke's random weights, at 2e-5 of their
largest magnitude); the frontends at 2e-5; the
qwen2-vl and musicgen smoke logits after ``prefill(embeds=)`` at 2e-3 in
f32 compute (``tests/test_models.py:61``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import frontends as jf  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import LM, frontends, layers  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402

QWEN, MUSICGEN = "qwen2-vl-2b", "musicgen-large"
F32 = dict(rtol=2e-5, atol=2e-5)             # test_kernels.py:23
TOL = dict(rtol=2e-3, atol=2e-3)             # test_models.py:61


class f32_compute:
    """JAX's model in f32 compute, restored to bf16 on exit."""

    def __enter__(self):
        jl.set_compute_dtype(jnp.float32)

    def __exit__(self, *exc):
        jl.set_compute_dtype(jnp.bfloat16)


_SETUPS = {}


def setup_of(arch):
    """(JAX config, JAX params, port config, port f32 LM) of the smoke,
    on one draw, built once."""
    if arch not in _SETUPS:
        jcfg = jax_get_smoke(arch)
        jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
        cfg = get_smoke(arch)
        p32 = from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                             torch.float32)
        _SETUPS[arch] = jcfg, jparams, cfg, LM.from_params(cfg, p32)
    return _SETUPS[arch]


def to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype (bf16 through f32,
    exactly)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))) \
            .to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_close_to_scale(got: torch.Tensor, want, tol: float = 2e-5):
    """max |got - want| <= tol * max |want|."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# -- M-RoPE -------------------------------------------------------------------


@pytest.mark.parametrize("batch, n_text, n_patches, grid_hw", [
    (1, 5, 9, None), (2, 7, 10, None), (3, 0, 16, None), (2, 4, 12, (3, 4)),
    (1, 6, 10, (2, 5)), (2, 3, 7, (3, 3)), (1, 450, 150, None)])
def test_mrope_positions_match_jax_exactly(batch, n_text, n_patches,
                                           grid_hw):
    want = np.asarray(jf.mrope_positions(batch, n_text, n_patches, grid_hw))
    got = frontends.mrope_positions(batch, n_text, n_patches, grid_hw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sections, theta", [((2, 3, 3), 1e4),
                                             ((2, 3, 3), 1e6),
                                             ((16, 24, 24), 1e6)])
def test_apply_mrope_matches_jax_on_distinct_streams(sections, theta):
    """x (B, H, S, hd) rotated by the three distinct streams of an image
    span and a text span; the rotation differs from plain RoPE's."""
    hd = 2 * sum(sections)
    B, H, n_img, n_txt = 2, 3, 12, 9
    x = np.random.default_rng(0).standard_normal((B, H, n_img + n_txt, hd),
                                                 np.float32)
    pos3 = np.array(jf.mrope_positions(B, n_txt, n_img, (3, 4)))
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3)[:, :, None],
                          sections, theta)
    got = layers.apply_mrope(torch.from_numpy(x),
                             torch.from_numpy(pos3)[:, :, None], sections,
                             theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    rope = layers.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(pos3[0])[:, None], theta)
    assert not torch.allclose(got, rope, **F32)


def test_apply_mrope_with_equal_streams_is_rope():
    """The serving path's case: (B, S) positions broadcast to the three
    streams rotate as plain RoPE does."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, 9, 16), np.float32))
    pos = torch.arange(9).expand(2, 9)
    got = layers.apply_mrope(x, pos[None, :, None].expand(3, 2, 1, 9),
                             (2, 3, 3))
    torch.testing.assert_close(got, layers.apply_rope(x, pos[:, None]),
                               rtol=0, atol=0)


def test_apply_mrope_refuses_sections_off_the_head_dim():
    x = torch.zeros(1, 1, 3, 16)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(x, torch.zeros(3, 1, 1, 3), (2, 3, 2))


def test_mrope_streams_is_built_once_a_device():
    a = layers.mrope_streams((2, 3, 3), torch.device("cpu"))
    assert a is layers.mrope_streams((2, 3, 3), torch.device("cpu"))
    assert a.tolist() == [0, 0, 1, 1, 1, 2, 2, 2]


def _attn_params(jparams):
    return {k: v[0] for k, v in jparams["blocks"]["attn"].items()}


def test_attention_prefill_with_3d_positions_matches_jax():
    jcfg, jparams, cfg, lm = setup_of(QWEN)
    B, n_img, n_txt = 2, 4, 9
    S = n_img + n_txt
    x = np.random.default_rng(4).standard_normal((B, S, cfg.d_model),
                                                 np.float32)
    pos3 = np.array(jf.mrope_positions(B, n_txt, n_img))
    with f32_compute():
        jout, jkv = jl.attention(_attn_params(jparams), jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos3),
                                 update_cache=True)
    out, kv = layers.attention(lm.layers[0].attn, torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos3),
                               update_cache=True)
    assert_close_to_scale(out, jout)
    for name in ("k", "v"):
        assert_close_to_scale(kv[name], jkv[name])


def test_attention_decode_with_3d_positions_matches_jax():
    """One decode step whose token sits at distinct (t, h, w) positions,
    over a partly filled cache."""
    jcfg, jparams, cfg, lm = setup_of(QWEN)
    rng = np.random.default_rng(5)
    B, S, KV, hd = 2, 16, cfg.n_kv_heads, cfg.hd
    pos = np.array([9, 3])
    kc = rng.standard_normal((B, KV, S, hd), np.float32)
    vc = rng.standard_normal((B, KV, S, hd), np.float32)
    for b, p in enumerate(pos):
        kc[b, :, p:] = 0.0
        vc[b, :, p:] = 0.0
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    pos3 = np.stack([pos, pos + 7, pos * 2 + 1])[:, :, None]   # (3, B, 1)
    with f32_compute():
        jout, jcache = jl.attention(
            _attn_params(jparams), jnp.asarray(x), jcfg,
            positions=jnp.asarray(pos3),
            cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            cache_pos=jnp.asarray(pos))
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    out, _ = layers.attention(lm.layers[0].attn, torch.from_numpy(x), cfg,
                              positions=torch.from_numpy(pos3),
                              cache=cache, cache_pos=torch.from_numpy(pos))
    assert_close_to_scale(out, jout)
    for name in ("k", "v"):
        assert_close_to_scale(cache[name], jcache[name])


# -- frontends ----------------------------------------------------------------


def test_encodec_token_embeds_matches_jax():
    rng = np.random.default_rng(6)
    embed = rng.standard_normal((128, 64), np.float32)
    cb = rng.integers(0, 128, (2, 4, 11))
    want = jf.encodec_token_embeds(jnp.asarray(embed), jnp.asarray(cb))
    got = frontends.encodec_token_embeds(torch.from_numpy(embed),
                                         torch.from_numpy(cb))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("S", [3, 20, 1100])
def test_input_embeds_for_audio_matches_jax(S):
    _, jparams, cfg, lm = setup_of(MUSICGEN)
    toks = tokens((2, S), 4 * cfg.vocab, seed=7)   # rolled, then % vocab
    want = jf.input_embeds_for(jax_get_smoke(MUSICGEN), jparams,
                               jnp.asarray(toks))
    got = frontends.input_embeds_for(cfg, {"embed": lm.embed},
                                     torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("S", [3, 20, 1100])
def test_input_embeds_for_vision_matches_jax(S, monkeypatch):
    """Patches (JAX's draw, monkeypatched into the port) then the unscaled
    text embeddings, both bf16: the text part is rounded even though the
    table is f32."""
    jcfg, jparams, cfg, lm = setup_of(QWEN)
    key = jax.random.PRNGKey(3)
    drawn = []

    def jax_patches(cfg_, batch, n, generator=None, device=None):
        drawn.append(n)
        return to_torch(jf.vision_patch_embeds(jcfg, batch, n, key))

    monkeypatch.setattr(frontends, "vision_patch_embeds", jax_patches)
    toks = tokens((2, S), cfg.vocab, seed=8)
    want = jf.input_embeds_for(jcfg, jparams, jnp.asarray(toks), key)
    got = frontends.input_embeds_for(cfg, {"embed": lm.embed},
                                     torch.from_numpy(toks))
    assert drawn == [min(S // 4, 256)]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **F32)


def test_vision_patch_embeds_draws_bf16_from_the_generator():
    cfg = get_config(QWEN)
    g = torch.Generator().manual_seed(11)
    a = frontends.vision_patch_embeds(cfg, 2, 256, g)
    b = frontends.vision_patch_embeds(cfg, 2, 256,
                                      torch.Generator().manual_seed(11))
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (2, 256, 1536)
    assert torch.equal(a, b)
    assert float(a.float().std()) == pytest.approx(0.02, rel=0.02)


def test_input_embeds_for_text_is_none():
    cfg = get_smoke("deepseek-7b")
    toks = torch.zeros(1, 4, dtype=torch.int64)
    assert frontends.input_embeds_for(cfg, {}, toks) is None


# -- LM.prefill(embeds=) ------------------------------------------------------


@pytest.mark.parametrize("arch", [QWEN, MUSICGEN])
def test_prefill_with_embeds_matches_jax(arch):
    """The frontend's embeddings (the same array in both) through prefill
    and 3 decode steps, f32 compute; the vision embeds are bf16 and the
    audio ones f32, each cast to the compute dtype unscaled."""
    jcfg, jparams, cfg, lm = setup_of(arch)
    B, S, extra = 2, 20, 3
    toks = tokens((B, S + extra), cfg.vocab, seed=9)
    jembeds = jf.input_embeds_for(jcfg, jparams, jnp.asarray(toks[:, :S]),
                                  jax.random.PRNGKey(4))
    jlm = JaxLM(jcfg)
    with f32_compute():
        jlogits, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :S]),
                                      S + extra, embeds=jembeds)
        jsteps = []
        for i in range(extra):
            jd, jcache = jlm.decode_step(
                jparams, jnp.asarray(toks[:, S + i]), jcache,
                jnp.full((B,), S + i, jnp.int32))
            jsteps.append(np.asarray(jd))
    logits, cache = lm.prefill(torch.from_numpy(toks[:, :S]), S + extra,
                               embeds=to_torch(jembeds))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i in range(extra):
        d, cache = lm.decode_step(torch.from_numpy(toks[:, S + i]), cache,
                                  torch.full((B,), S + i))
        np.testing.assert_allclose(d.numpy(), jsteps[i], **TOL)
    # the embeds replaced the token embeddings: a token prefill differs
    plain, _ = lm.prefill(torch.from_numpy(toks[:, :S]), S + extra)
    assert not torch.allclose(plain, logits, **TOL)


def test_embed_vectors_casts_without_scale():
    cfg = get_smoke(QWEN)
    lm = LM(cfg, device="cpu", dtype=torch.bfloat16)
    e = torch.randn(1, 3, cfg.d_model)
    assert torch.equal(lm.embed_vectors(e), e.to(torch.bfloat16))
