"""The attention logit softcap and head dim 240 in the port, on the CPU.

* The plain flash and decode versions with a cap against the JAX model's
  capped attention (``repro.models.layers.flash_attention_xla`` and
  ``attend_cache`` with ``softcap=``) at 2e-5 in f32, and the decode of
  a ring cache (lengths min(pos + 1, W)) against ``attend_cache`` over
  the same ring's key positions and window.
* The plain versions at hd 240 (gemma3-12b's head dim) against the JAX
  oracle (``repro.kernels.ref``) and the Pallas kernels in interpret
  mode, as test_kernels.py runs them.
* The deepseek-7b and gemma3-12b smokes with ``attn_logit_softcap`` set
  to a cap that binds, against the JAX ``LM`` in f32 (2e-3), and their
  loss and every gradient leaf of ``loss_and_grads`` against
  ``jax.value_and_grad`` of JAX's capped ``LM.loss`` at each leaf's
  rounding floor (``tests/test_torch_family_grads.py``'s rule).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.kernels import decode_attention as pallas_decode  # noqa: E402
from repro.kernels import flash_attention as pallas_flash  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.models.transformer import _ring_positions  # noqa: E402
from repro.training import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import LM  # noqa: E402
from repro_torch.params import from_jax_numpy, to_jax_numpy  # noqa: E402
from repro_torch.training import loss_and_grads  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)            # test_kernels.py:23
BF16 = dict(rtol=2e-2, atol=2e-2)
MODEL = dict(rtol=2e-3, atol=2e-3)          # test_models.py:61
# the gradient floor (tests/test_torch_family_grads.py): each leaf within
# twice its max over FLOOR_DRAWS one-ulp nudges of every f32 weight, or
# FLOOR_MIN where that is larger; a floor past FLOOR_CEILING fails
FLOOR_DRAWS, FLOOR_MIN, FLOOR_CEILING = 2, 1e-4, 0.02


def draw(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def bind(s, cap):
    """max |score| / cap: > 1 where the cap bends the scores."""
    return float(np.abs(s).max()) / cap


# -- the plain versions with a cap, against the JAX model's attention -------

@pytest.mark.parametrize("sq,window,cap", [
    (40, 0, 2.0), (40, 9, 2.0), (33, 0, 0.5), (70, 16, 1.0)])
def test_flash_plain_softcap_matches_flash_attention_xla(sq, window, cap):
    """q (B KV G, S, hd) rows as JAX's (B, KV, G, S, hd): GQA G = 2."""
    rng = np.random.default_rng(sq + window)
    B, KV, G, hd = 2, 2, 2, 32
    q = draw(rng, (B, KV, G, sq, hd), 2.0)
    k, v = draw(rng, (B, KV, sq, hd), 2.0), draw(rng, (B, KV, sq, hd))
    assert bind(np.einsum("bkgqh,bkth->bkgqt", q, k) / math.sqrt(hd),
                cap) > 2
    exp = jl.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window, softcap=cap,
                                 q_block=16, k_block=16)
    out = flash_attention_plain(
        torch.from_numpy(q.reshape(B * KV * G, sq, hd)),
        torch.from_numpy(k.reshape(B * KV, sq, hd)),
        torch.from_numpy(v.reshape(B * KV, sq, hd)),
        window=window, softcap=cap)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(exp).reshape(B * KV * G, sq, hd),
                               **F32)
    uncapped = flash_attention_plain(
        torch.from_numpy(q.reshape(B * KV * G, sq, hd)),
        torch.from_numpy(k.reshape(B * KV, sq, hd)),
        torch.from_numpy(v.reshape(B * KV, sq, hd)), window=window)
    assert float((out - uncapped).abs().max()) > 1e-2


@pytest.mark.parametrize("cap", [0.5, 3.0])
def test_decode_plain_softcap_matches_attend_cache(cap):
    rng = np.random.default_rng(int(cap * 10))
    B, KV, G, S, hd = 3, 2, 2, 40, 16
    q = draw(rng, (B, KV, G, 1, hd), 2.0)
    k, v = draw(rng, (B, KV, S, hd), 2.0), draw(rng, (B, KV, S, hd))
    pos = np.array([39, 7, 0], np.int32)
    exp = jl.attend_cache(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos), softcap=cap)
    lengths = torch.from_numpy(np.repeat(pos + 1, KV * G).astype(np.int32))
    out = decode_attention_plain(
        torch.from_numpy(q.reshape(B * KV * G, 1, hd)),
        torch.from_numpy(k.reshape(B * KV, S, hd)),
        torch.from_numpy(v.reshape(B * KV, S, hd)), lengths, softcap=cap)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(exp).reshape(B * KV * G, 1, hd),
                               **F32)


@pytest.mark.parametrize("cap", [0.0, 1.0])
def test_decode_of_a_ring_matches_attend_cache_with_key_positions(cap):
    """A ring of W slots holding position p at slot p % W, read with
    lengths min(pos + 1, W) and no window, against JAX's decode over the
    same slots labelled by ``_ring_positions`` and masked by the window."""
    rng = np.random.default_rng(7)
    B, KV, G, W, hd = 4, 2, 2, 16, 16
    q = draw(rng, (B, KV, G, 1, hd), 2.0)
    k, v = draw(rng, (B, KV, W, hd), 2.0), draw(rng, (B, KV, W, hd))
    pos = np.array([3, 15, 16, 37], np.int32)      # below, at and past W
    exp = jl.attend_cache(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos), window=W, softcap=cap,
                          key_positions=_ring_positions(jnp.asarray(pos), W))
    lengths = np.repeat(np.minimum(pos + 1, W), KV * G).astype(np.int32)
    out = ops.decode_attention(
        torch.from_numpy(q.reshape(B * KV * G, 1, hd)),
        torch.from_numpy(k.reshape(B * KV, W, hd)),
        torch.from_numpy(v.reshape(B * KV, W, hd)),
        torch.from_numpy(lengths), softcap=cap)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(exp).reshape(B * KV * G, 1, hd),
                               **F32)


# -- the plain versions at hd 240 --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,window", [(96, 0), (130, 48)])
def test_flash_plain_hd240_matches_ref_and_pallas(dtype, sq, window):
    rng = np.random.default_rng(sq + window)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32" else
                (torch.bfloat16, jnp.bfloat16))
    q, k, v = (draw(rng, (2, sq, 240)) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, window=window).float().numpy()
    exp = np.asarray(ref.flash_attention_ref(jq, jk, jv, window=window),
                     np.float32)
    pal = np.asarray(pallas_flash(jq, jk, jv, window=window, q_block=64,
                                  k_block=64, interpret=True), np.float32)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(out, exp, **tol)
    np.testing.assert_allclose(out, pal, **tol)


@pytest.mark.parametrize("window", [0, 40])
def test_decode_plain_hd240_matches_ref_and_pallas(window):
    """hd 240 over a cache of 128 slots, lengths full, ragged and 1 (a
    ring's min(pos + 1, W) and a linear cache's pos + 1 alike)."""
    rng = np.random.default_rng(240 + window)
    q = draw(rng, (4, 1, 240))
    k, v = draw(rng, (4, 128, 240)), draw(rng, (4, 128, 240))
    lengths = np.array([128, 77, 1, 64], np.int32)
    out = decode_attention_plain(*map(torch.from_numpy, (q, k, v, lengths)),
                                 window=window).numpy()
    exp = np.asarray(ref.decode_attention_ref(
        *map(jnp.asarray, (q, k, v, lengths)), window=window))
    pal = np.asarray(pallas_decode(*map(jnp.asarray, (q, k, v, lengths)),
                                   k_block=64, window=window,
                                   interpret=True))
    np.testing.assert_allclose(out, exp, **F32)
    np.testing.assert_allclose(out, pal, **F32)


# -- models with a cap that binds -------------------------------------------

CAP = 1.0


@pytest.fixture(scope="module", params=["deepseek-7b", "gemma3-12b"])
def capped(request):
    """(JAX config, JAX params, the port's f32 LM, and the same uncapped)
    with attn_logit_softcap = CAP."""
    arch = request.param
    jcfg = jax_get_smoke(arch).with_(attn_logit_softcap=CAP)
    cfg = get_smoke(arch).with_(attn_logit_softcap=CAP)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    p32 = from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                         torch.float32)
    uncapped = LM.from_params(cfg.with_(attn_logit_softcap=0.0), p32)
    return jcfg, jparams, LM.from_params(cfg, p32), uncapped


def test_capped_logits_train_matches_jax(capped):
    jcfg, jparams, lm, uncapped = capped
    toks = np.random.default_rng(3).integers(0, 256, (2, 24))
    jl.set_compute_dtype(jnp.float32)
    try:
        exp = np.asarray(JaxLM(jcfg).logits_train(jparams,
                                                  jnp.asarray(toks)))
    finally:
        jl.set_compute_dtype(jnp.bfloat16)
    out = lm.logits_train(torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), exp, **MODEL)
    # the cap binds: the uncapped model is far from these logits
    free = uncapped.logits_train(torch.from_numpy(toks)).numpy()
    assert np.abs(free - exp).max() > 50 * MODEL["atol"]


def test_capped_prefill_and_decode_match_jax(capped):
    """A 16-token prompt (gemma3: the ring's W, aligned in JAX too) and 4
    decode steps, the last ones past W."""
    jcfg, jparams, lm, _ = capped
    toks = np.random.default_rng(4).integers(0, 256, (2, 20))
    jlm = JaxLM(jcfg)
    jl.set_compute_dtype(jnp.float32)
    try:
        jlog, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :16]), 32)
        ref_steps = [np.asarray(jlog)]
        for i in range(4):
            jlog, jcache = jlm.decode_step(
                jparams, jnp.asarray(toks[:, 16 + i], jnp.int32), jcache,
                jnp.full((2,), 16 + i, jnp.int32))
            ref_steps.append(np.asarray(jlog))
    finally:
        jl.set_compute_dtype(jnp.bfloat16)
    with torch.inference_mode():
        logits, cache = lm.prefill(torch.from_numpy(toks[:, :16]), 32)
        steps = [logits.numpy()]
        for i in range(4):
            logits, cache = lm.decode_step(torch.from_numpy(toks[:, 16 + i]),
                                           cache, torch.full((2,), 16 + i))
            steps.append(logits.numpy())
    for a, b in zip(steps, ref_steps, strict=True):
        np.testing.assert_allclose(a, b, **MODEL)


def test_the_smoke_scores_exceed_the_cap(capped):
    """At layer 0 the scaled scores of the prompt reach past CAP, so the
    cap bends them (max |s| / cap > 1)."""
    from repro_torch.models import layers
    _, _, lm, _ = capped
    cfg = lm.cfg
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256,
                                                              (2, 24)))
    x = lm.embed_tokens(toks)
    attn = lm.layers[0].attn
    h = layers.rmsnorm(x, attn.norm, cfg.norm_eps)
    pos = torch.arange(24).expand(2, 24)
    q, k, _ = layers._qkv(attn, h, cfg, pos)
    s = torch.einsum("bkgqh,bkth->bkgqt", q, k) / math.sqrt(cfg.hd)
    assert bind(s.numpy(), CAP) > 1.5


def test_capped_grads_match_jax_at_the_rounding_floor(capped):
    """The capped smoke's loss and every gradient leaf (``loss_and_grads``,
    autograd through the capped plain flash: the route the card's capped
    backward kernels are held to) against ``jax.value_and_grad`` of JAX's
    capped ``LM.loss`` in f32, on a SyntheticLM batch of 2 x 32: the loss
    within 1e-5 (or twice its floor), each leaf within twice its floor or
    FLOOR_MIN; and the cap moves the gradients."""
    jcfg, jparams, lm, uncapped = capped
    cfg = lm.cfg
    tree = jax.tree.map(np.asarray, jparams)
    b = {k: np.asarray(v) for k, v in JaxSyntheticLM(
        vocab=cfg.vocab, seq_len=32, batch=2, seed=0).next_batch().items()}
    jl.set_compute_dtype(jnp.float32)
    try:
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: JaxLM(jcfg).loss(p, b["tokens"], b["targets"])))(jparams)
    finally:
        jl.set_compute_dtype(jnp.bfloat16)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    def port(tr, c=cfg):
        m = LM.from_params(c, from_jax_numpy(tr, c, "cpu", torch.float32))
        for p in m.parameters():
            p.requires_grad_(True)
        loss, grads = loss_and_grads(m, tb, TrainConfig())
        return float(loss), to_jax_numpy(grads, c)

    loss, got = port(tree)
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]

    def leaf(g, path):
        for p in path:
            g = g[p.key]
        return np.asarray(g)
    rng = np.random.default_rng(1)
    floor = {"loss": 0.0}
    for _ in range(FLOOR_DRAWS):
        nudged = jax.tree.map(
            lambda a: np.nextafter(a, np.where(
                rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(a.dtype))
            if a.dtype == np.float32 else a, tree)
        moved_loss, moved = port(nudged)
        floor["loss"] = max(floor["loss"], abs(moved_loss - loss) / abs(loss))
        for path, _ in leaves:
            g, k = leaf(got, path), jax.tree_util.keystr(path)
            floor[k] = max(floor.get(k, 0.0), float(
                np.abs(leaf(moved, path) - g).max()
                / max(np.abs(g).max(), 1e-30)))
    assert abs(loss - float(jloss)) <= max(1e-5, 2 * floor["loss"]) \
        * abs(float(jloss))
    assert max(floor.values()) < FLOOR_CEILING, floor
    bad, moved_by_cap = {}, 0.0
    _, free = port(tree, uncapped.cfg)
    for path, want in leaves:
        k, want, g = jax.tree_util.keystr(path), np.asarray(want), \
            leaf(got, path)
        assert g.shape == want.shape and np.isfinite(g).all(), k
        scale = max(float(np.abs(want).max()), 1e-30)
        rel = float(np.abs(g - want).max()) / scale
        if not rel <= max(2 * floor[k], FLOOR_MIN):
            bad[k] = (rel, floor[k])
        moved_by_cap = max(moved_by_cap, float(
            np.abs(leaf(free, path) - want).max()) / scale)
    assert not bad, bad
    assert moved_by_cap > 100 * FLOOR_MIN
