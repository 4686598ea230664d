"""Head dim 168 (gemma3-27b: d 5376 over 32 heads) in the port, on the CPU.

* The plain flash and decode versions at hd 168 against the JAX oracle
  (``repro.kernels.ref``) and the Pallas kernels in interpret mode, as
  test_kernels.py runs them (f32 2e-5, bf16 2e-2).
* The gemma3-27b smoke at a width that keeps hd 168 (d 336 over 2 query
  heads and 1 KV head; 13 layers: two groups of 5 local + 1 global and
  a local tail, window 16) against the JAX ``LM`` in f32 (2e-3, as
  test_models.py): ``logits_train``, prefill and 4 decode steps where
  JAX's window cache is ring-aligned (S <= W or a multiple of W), the
  port's decode after a 20-token prompt against JAX's ``logits_train``
  (JAX's own decode misplaces its ring there, ROADMAP.md §3), and the
  two engines' tokens, preemptions and bills.

The kernels' own arithmetic at hd 168 (the bf16 flash kernel's padded
k-step and O group, the decode kernel's lanes) is emulated in
test_torch_attention_design.py; the kernels run on the card only
(test_torch_cuda.py, chip_smoke.py).
"""
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
from repro.models import model_specs  # noqa: E402
from repro.models.layers import set_compute_dtype  # noqa: E402
from repro.serving import LiveRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels.common import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.transformer import lg_groups  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402
from repro_torch.serving import LiveRequest, ServingEngine  # noqa: E402

HD = 168
F32 = dict(rtol=2e-5, atol=2e-5)            # test_kernels.py:23
BF16 = dict(rtol=2e-2, atol=2e-2)
MODEL = dict(rtol=2e-3, atol=2e-3)          # test_models.py:61
ARCH = "gemma3-27b"
NARROW = dict(d_model=2 * HD, n_heads=2, n_kv_heads=1)
W, STEPS, MAX_LEN = 16, 4, 48
ENGINE_KW = dict(n_slots=4, n_fifo=2, max_len=MAX_LEN, initial_limit_ms=12.0)


def draw(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


class f32_compute:
    """JAX's model in f32 compute, restored to bf16 on exit."""

    def __enter__(self):
        set_compute_dtype(jnp.float32)

    def __exit__(self, *exc):
        set_compute_dtype(jnp.bfloat16)


def test_gemma3_27b_head_dim_is_a_kernel_head_dim():
    cfg = get_config(ARCH)
    assert cfg.hd == HD and HD in HEAD_DIMS
    assert HD % 8 == 0 and HD % 16 != 0      # padded in the bf16 kernel
    assert get_smoke(ARCH).with_(**NARROW).hd == HD


# -- the plain versions against the oracle and the Pallas kernels ------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,causal,window", [
    (2, 96, 96, True, 0),         # ragged against the 64-row blocks
    (2, 130, 130, True, 48),      # a window across block edges
    (2, 64, 128, False, 0)])      # Sq != Sk
def test_flash_plain_hd168_matches_ref_and_pallas(dtype, bh, sq, sk, causal,
                                                  window):
    rng = np.random.default_rng(sq + sk + window)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32" else
                (torch.bfloat16, jnp.bfloat16))
    q, k, v = draw(rng, (bh, sq, HD)), draw(rng, (bh, sk, HD)), \
        draw(rng, (bh, sk, HD))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=causal,
                                window=window).float().numpy()
    exp = np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                             window=window), np.float32)
    pal = np.asarray(pallas_flash(jq, jk, jv, causal=causal, window=window,
                                  q_block=64, k_block=64, interpret=True),
                     np.float32)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(out, exp, **tol)
    np.testing.assert_allclose(out, pal, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 40])
def test_decode_plain_hd168_matches_ref_and_pallas(dtype, window):
    """hd 168 over a cache of 128 slots, lengths full, ragged and 1 (a
    ring's min(pos + 1, W) and a linear cache's pos + 1 alike)."""
    rng = np.random.default_rng(HD + window)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32" else
                (torch.bfloat16, jnp.bfloat16))
    q = draw(rng, (4, 1, HD))
    k, v = draw(rng, (4, 128, HD)), draw(rng, (4, 128, HD))
    lengths = np.array([128, 77, 1, 64], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths),
                                 window=window).float().numpy()
    exp = np.asarray(ref.decode_attention_ref(
        jq, jk, jv, jnp.asarray(lengths), window=window), np.float32)
    pal = np.asarray(pallas_decode(jq, jk, jv, jnp.asarray(lengths),
                                   k_block=64, window=window,
                                   interpret=True), np.float32)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(out, exp, **tol)
    np.testing.assert_allclose(out, pal, **tol)


# -- gemma3-27b at hd 168 against the JAX model ------------------------------

def tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


@pytest.fixture(scope="module")
def narrow():
    """(JAX config, JAX params, the port's f32 LM on the same weights,
    token rows, JAX's f32 logits_train of them)."""
    jcfg = jax_get_smoke(ARCH).with_(**NARROW)
    cfg = get_smoke(ARCH).with_(**NARROW)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    p32 = from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                         torch.float32)
    toks = tokens((2, 32 + STEPS))
    with f32_compute():
        full = np.asarray(JaxLM(jcfg).logits_train(jparams,
                                                   jnp.asarray(toks)))
    return jcfg, jparams, LM.from_params(cfg, p32), toks, full, p32


def test_narrow_config_keeps_the_groups_and_the_tail(narrow):
    cfg = narrow[2].cfg
    assert (cfg.n_layers, cfg.hd, cfg.n_heads // cfg.n_kv_heads) == (13, HD,
                                                                     2)
    assert lg_groups(cfg) == (2, 1)
    assert cfg.local_window == W


def test_logits_train_hd168_matches_jax(narrow):
    _, _, lm, toks, full, _ = narrow
    out = lm.logits_train(torch.from_numpy(toks)).numpy()
    assert out.shape == full.shape
    np.testing.assert_allclose(out, full, **MODEL)


def port_steps(lm, toks, S):
    B = toks.shape[0]
    with torch.inference_mode():
        logits, cache = lm.prefill(torch.from_numpy(toks[:, :S]), MAX_LEN)
        out = [logits[:, 0].numpy()]
        for i in range(STEPS):
            logits, cache = lm.decode_step(
                torch.from_numpy(toks[:, S + i]), cache,
                torch.full((B,), S + i))
            out.append(logits[:, 0].numpy())
    return out


@pytest.mark.parametrize("S", [12, 16, 32])
def test_prefill_and_decode_hd168_match_jax(narrow, S):
    """Prompts where JAX's window cache is ring-aligned: the port's prefill
    and 4 decode steps (at S 12 and 16 they wrap the ring) against JAX's
    prefill / decode_step, and against logits_train."""
    jcfg, jparams, lm, toks, full, _ = narrow
    B = toks.shape[0]
    jlm = JaxLM(jcfg)
    with f32_compute():
        logits, cache = jlm.prefill(jparams, jnp.asarray(toks[:, :S]),
                                    MAX_LEN)
        ref_steps = [np.asarray(logits)[:, 0]]
        for i in range(STEPS):
            logits, cache = jlm.decode_step(
                jparams, jnp.asarray(toks[:, S + i], jnp.int32), cache,
                jnp.full((B,), S + i, jnp.int32))
            ref_steps.append(np.asarray(logits)[:, 0])
    for i, (a, b) in enumerate(zip(port_steps(lm, toks, S), ref_steps,
                                   strict=True)):
        np.testing.assert_allclose(a, b, **MODEL)
        np.testing.assert_allclose(a, full[:, S - 1 + i], **MODEL)


def test_decode_after_a_prompt_off_the_ring_hd168_matches_logits_train(
        narrow):
    """A 20-token prompt (> W, not a multiple of it): the port's prefill and
    decode steps against JAX's logits_train, the model's definition."""
    _, _, lm, toks, full, _ = narrow
    for i, a in enumerate(port_steps(lm, toks, 20)):
        np.testing.assert_allclose(a, full[:, 19 + i], **MODEL)


def test_engine_hd168_matches_jax_engine(narrow):
    """Both engines on ring-aligned prompts (JAX's cache is then the
    port's), decode running past W: the same tokens, preemptions, times
    and bills."""
    jcfg, jparams, _, _, _, p32 = narrow
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (1, n))
               for n in (6, 16, 9, 12, 3, 32)]
    new = [3 + rid * 3 - (rid == 5) * 3 for rid in range(len(prompts))]
    with f32_compute():
        jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
        for rid, p in enumerate(prompts):
            jeng.submit(JaxRequest(rid=rid, arrival_ms=0.0,
                                   tokens=jnp.asarray(p, jnp.int32),
                                   max_new=new[rid]))
        jdone = jeng.run()
    eng = ServingEngine(get_smoke(ARCH).with_(**NARROW), p32, device="cpu",
                        **ENGINE_KW)
    for rid, p in enumerate(prompts):
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0,
                               tokens=torch.from_numpy(p), max_new=new[rid]))
    done = eng.run()
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for a, b in zip(done, jdone):
        assert a.generated == b.generated
    assert max(r.tokens.shape[1] + len(r.generated) for r in done) > W + 1
    assert [r.preemptions for r in done] == [r.preemptions for r in jdone]
    assert sum(r.preemptions for r in done) >= 1
    assert [r.completion_ms for r in done] == [r.completion_ms for r in jdone]
    assert [r.cost_usd() for r in done] == [r.cost_usd() for r in jdone]
