"""Gradients of the port's norm and attention on the CPU.

* The plain versions' gradients (autograd) against ``jax.grad`` of the
  JAX references (``repro.kernels.ref`` and the model's
  ``flash_attention_xla``) at hd 64, 128, 168 and 240, GQA, windows and
  ragged S.
* A design test of the backward kernels (``csrc/fused_rmsnorm.cu``'s
  backward, ``csrc/flash_attention_bwd.cu``): their tiling, the tiles
  they skip and their fixed reduction orders emulated in PyTorch (32-row
  query and 32-key tiles, dK/dV summed over the G query heads of a KV
  head and the query tiles in order, dQ separately over the key tiles;
  dw partials of 16-row blocks summed in groups of 32 blocks), run
  through the autograd Functions on the CPU with the kernels replaced by
  the emulation, against autograd through the plain versions. Keep the
  emulation in step with the .cu files.
* The guards: ``decode_attention``, ``ssm_scan``, ``rwkv6_scan`` and a
  capped ``flash_attention`` refuse a gradient in their CUDA wrappers,
  before any device check.

Tolerances: f32 2e-5 (tests/test_kernels.py:23) for elementwise outputs;
dw, a sum over N rows, at 2e-5 * sqrt(N) (the rounding of a sum of N
unit-scale f32 terms grows as sqrt(N) in any order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import flash_attention_xla  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_rmsnorm as rn  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_cuda  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
TILE = 32              # the backward kernels' query rows and keys a tile


def dw_tol(n):
    t = 2e-5 * math.sqrt(n)
    return dict(rtol=t, atol=t)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# -- plain versions against jax.grad -----------------------------------------

@pytest.mark.parametrize("n,d", [(1, 64), (37, 128), (300, 96)])
def test_plain_rmsnorm_grads_match_jax(n, d):
    x, w, dy = arrays(n, (n, d), (d,), (n, d))
    w = w * 0.1

    def f(x, w):
        return jnp.sum(jref.fused_rmsnorm_ref(x, w) * dy)
    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    dx, dw = rn.fused_rmsnorm_bwd_plain(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **dw_tol(n))


# (bh, bh_kv, s, hd, window)
ATTN = [(4, 4, 70, 64, 0), (2, 2, 33, 128, 0), (4, 2, 65, 168, 0),
        (2, 1, 40, 240, 0), (6, 2, 63, 64, 0), (3, 3, 130, 32, 20),
        (4, 2, 1, 128, 0), (6, 2, 97, 168, 33)]


@pytest.mark.parametrize("bh,bh_kv,s,hd,window", ATTN)
def test_plain_flash_grads_match_jax(bh, bh_kv, s, hd, window):
    """autograd through flash_attention_plain against jax.grad of the JAX
    model's flash_attention_xla (q (B, KV, G, S, hd), GQA native; blocks
    of 32 so that the online softmax spans several) and, without GQA, of
    kernels.ref.flash_attention_ref."""
    q, k, v, do = arrays(bh + s + hd, (bh, s, hd), (bh_kv, s, hd),
                         (bh_kv, s, hd), (bh, s, hd))
    G = bh // bh_kv
    dq, dk, dv = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)), window=window)

    def f(q, k, v):
        out = flash_attention_xla(q.reshape(1, bh_kv, G, s, hd),
                                  k[None], v[None], causal=True,
                                  window=window, q_block=32, k_block=32)
        return jnp.sum(out.reshape(bh, s, hd) * do)
    jq, jk, jv = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for got, want in ((dq, jq), (dk, jk), (dv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if G == 1:
        def g(q, k, v):
            return jnp.sum(jref.flash_attention_ref(
                q, k, v, causal=True, window=window) * do)
        jq, jk, jv = jax.grad(g, argnums=(0, 1, 2))(q, k, v)
        for got, want in ((dq, jq), (dk, jk), (dv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the backward kernels' design, emulated -----------------------------------

def emulate_rmsnorm_bwd(x, w, dy, eps=1e-6, rows=rn.BWD_ROWS):
    """rmsnorm_bwd_rows_kernel then rmsnorm_bwd_dw_kernel: blocks of
    ``rows`` rows (r and the row's coefficient b r^3 / d), each block's dw
    partial summed over its rows in order, the partials in groups of 32
    blocks, then the groups in order."""
    n, d = x.shape
    xf, g = x.float(), dy.float()
    wc = 1.0 + w
    r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    coef = (g * wc * xf).sum(-1, keepdim=True) * r ** 3 / d
    dx = (r * wc * g - xf * coef).to(x.dtype)
    partials = []
    for b0 in range(0, n, rows):
        acc = torch.zeros(d)
        for i in range(b0, min(b0 + rows, n)):
            acc = acc + g[i] * xf[i] * r[i]
        partials.append(acc)
    dw = torch.zeros(d)
    for g0 in range(0, len(partials), 32):
        s = torch.zeros(d)
        for p in partials[g0:g0 + 32]:
            s = s + p
        dw = dw + s
    return dx, dw


def _scores(q, k, v, do, lse, delta, q0, k0, sq, sk, causal, window, scale):
    """One (query tile, key tile) pair: P and dS = P (dP - D), masked."""
    qi = torch.arange(q0, q0 + q.shape[0])[:, None]
    key = torch.arange(k0, k0 + k.shape[0])[None, :]
    ok = (qi < sq) & (key < sk)
    if causal:
        ok &= key <= qi
    if window > 0:
        ok &= key > qi - window
    p = torch.where(ok, torch.exp(q @ k.T * scale - lse[:, None]), 0.0)
    return p, p * (do @ v.T - delta[:, None])


def emulate_dkdv(q, k, v, do, lse, delta, *, causal=True, window=0):
    """flash_bwd_dkdv_kernel: a block per (32-key tile, KV head); the query
    rows that can see the tile, q >= k0 (causal) and q < k_max + W
    (window), in 32-row tiles, for each of the G query heads in order."""
    BH, sq, hd = q.shape
    bh_kv, sk, _ = k.shape
    G, scale = BH // bh_kv, 1.0 / math.sqrt(hd)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for kvh in range(bh_kv):
        for k0 in range(0, sk, TILE):
            kt, vt = k[kvh, k0:k0 + TILE].float(), v[kvh, k0:k0 + TILE].float()
            k_max = min(k0 + TILE, sk) - 1
            q_lo = k0 if causal else 0
            q_hi = min(sq, k_max + window) if window > 0 else sq
            dk_acc, dv_acc = torch.zeros(kt.shape), torch.zeros(vt.shape)
            for g in range(G):
                bh = kvh * G + g
                for q0 in range(q_lo, q_hi, TILE):
                    sl = slice(q0, q0 + TILE)
                    qt, dot = q[bh, sl].float(), do[bh, sl].float()
                    p, ds = _scores(qt, kt, vt, dot, lse[bh, sl],
                                    delta[bh, sl], q0, k0, sq, sk, causal,
                                    window, scale)
                    dv_acc += p.T @ dot
                    dk_acc += ds.T @ qt
            dk[kvh, k0:k0 + TILE] = dk_acc * scale
            dv[kvh, k0:k0 + TILE] = dv_acc
    return dk.to(k.dtype), dv.to(v.dtype)


def emulate_dq(q, k, v, do, lse, delta, *, causal=True, window=0):
    """flash_bwd_dq_kernel: a block per (32-row query tile, query head);
    the keys its rows see, k <= q_last (causal) and k > q0 - W (window,
    from the 32-key tile holding it), in order."""
    BH, sq, hd = q.shape
    bh_kv, sk, _ = k.shape
    G, scale = BH // bh_kv, 1.0 / math.sqrt(hd)
    dq = torch.zeros(q.shape)
    for bh in range(BH):
        kvh = bh // G
        for q0 in range(0, sq, TILE):
            sl = slice(q0, q0 + TILE)
            qt, dot = q[bh, sl].float(), do[bh, sl].float()
            q_last = min(q0 + TILE, sq) - 1
            k_hi = min(sk, q_last + 1) if causal else sk
            k_lo = max(0, q0 - window + 1) // TILE * TILE if window > 0 else 0
            acc = torch.zeros(qt.shape)
            for k0 in range(k_lo, k_hi, TILE):
                kt = k[kvh, k0:k0 + TILE].float()
                vt = v[kvh, k0:k0 + TILE].float()
                _, ds = _scores(qt, kt, vt, dot, lse[bh, sl], delta[bh, sl],
                                q0, k0, sq, sk, causal, window, scale)
                acc += ds @ kt
            dq[bh, sl] = acc * scale
    return dq.to(q.dtype)


@pytest.fixture
def emulated_kernels(monkeypatch):
    """The Functions' kernels replaced by the plain forward (with the
    plain log-sum-exp) and the emulated backward, so that the autograd
    wiring of the card runs on CPU tensors."""
    def flash_forward(q, k, v, causal, window, softcap, out, lse):
        out.copy_(fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window))
        if lse is not None:
            lse.copy_(fa.flash_lse_plain(q, k, causal=causal, window=window))
        return out
    monkeypatch.setattr(fa, "_forward", flash_forward)
    monkeypatch.setattr(fa, "flash_bwd_preprocess_cuda",
                        fa.flash_bwd_preprocess_plain)
    monkeypatch.setattr(fa, "flash_bwd_dkdv_cuda", emulate_dkdv)
    monkeypatch.setattr(fa, "flash_bwd_dq_cuda", emulate_dq)
    monkeypatch.setattr(rn, "_forward",
                        lambda x, w, eps: rn.fused_rmsnorm_plain(x, w, eps=eps))
    monkeypatch.setattr(rn, "fused_rmsnorm_bwd_cuda",
                        lambda x, w, dy, eps: emulate_rmsnorm_bwd(x, w, dy,
                                                                  eps))


@pytest.mark.parametrize("n,d", [(1, 4096), (77, 64), (1000, 48), (16, 8)])
def test_rmsnorm_backward_design_matches_plain(emulated_kernels, n, d):
    x, w, dy = (torch.from_numpy(a) for a in arrays(n + d, (n, d), (d,),
                                                    (n, d)))
    w = w * 0.1
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = rn.FusedRMSNorm.apply(xg, wg, 1e-6)
    out.backward(dy)
    want_dx, want_dw = rn.fused_rmsnorm_bwd_plain(x, w, dy)
    torch.testing.assert_close(out, rn.fused_rmsnorm_plain(x, w), **TOL)
    torch.testing.assert_close(xg.grad, want_dx, **TOL)
    torch.testing.assert_close(wg.grad, want_dw, **dw_tol(n))


# (bh, bh_kv, sq, sk, hd, causal, window): GQA (G = 2, 3), windows across
# and inside tiles, S on and beside the 32 edges, S 1, Sq != Sk, non-causal
DESIGN = [(4, 4, 96, 96, 16, True, 0), (6, 2, 77, 77, 32, True, 0),
          (3, 1, 65, 65, 16, True, 20), (2, 2, 130, 130, 64, True, 33),
          (2, 2, 1, 1, 16, True, 0), (2, 2, 63, 63, 168, True, 0),
          (2, 1, 40, 100, 16, True, 0), (4, 2, 50, 70, 32, False, 0),
          (2, 2, 64, 64, 240, True, 5), (3, 3, 31, 31, 16, False, 8)]


@pytest.mark.parametrize("bh,bh_kv,sq,sk,hd,causal,window", DESIGN)
def test_flash_backward_design_matches_plain(emulated_kernels, bh, bh_kv, sq,
                                             sk, hd, causal, window):
    q, k, v, do = (torch.from_numpy(a) for a in arrays(
        bh + sq + sk + hd, (bh, sq, hd), (bh_kv, sk, hd), (bh_kv, sk, hd),
        (bh, sq, hd)))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa.FlashAttention.apply(qg, kg, vg, causal, window)
    out.backward(do)
    with torch.enable_grad():
        qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
        fa.flash_attention_plain(qp, kp, vp, causal=causal,
                                 window=window).backward(do)
    for got, want in ((qg.grad, qp.grad), (kg.grad, kp.grad),
                      (vg.grad, vp.grad)):
        torch.testing.assert_close(got, want, **TOL)


def test_flash_lse_plain_is_the_log_normaliser():
    """The log-sum-exp the forward hands the backward: exp(s - lse) sums to
    1 over each row's unmasked keys, which is what P is recomputed from."""
    q, k = (torch.from_numpy(a) for a in arrays(3, (2, 40, 16), (1, 40, 16)))
    lse = fa.flash_lse_plain(q, k, window=7)
    s = q @ k.repeat_interleave(2, 0).transpose(1, 2) / 4.0
    i, j = torch.arange(40)[:, None], torch.arange(40)[None, :]
    p = torch.where((j <= i) & (j > i - 7), torch.exp(s - lse[..., None]), 0)
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 40), **TOL)


# -- guards ---------------------------------------------------------------------

def _guarded_calls():
    t = torch.zeros(2, 16, 16, requires_grad=True)
    lengths = torch.ones(2, dtype=torch.int32)
    return {
        "decode_attention": lambda: decode_attention_cuda(
            t[:, :1], t, t, lengths),
        "ssm_scan": lambda: ssm_scan_cuda(t, t, t, torch.zeros(2, 16),
                                          chunk=16),
        "rwkv6_scan": lambda: rwkv6_scan_cuda(t, t, t, t, torch.zeros(2, 16)),
        "flash_attention softcap": lambda: fa.flash_attention_cuda(
            t, t, t, softcap=2.0),
    }


@pytest.mark.parametrize("name", list(_guarded_calls()))
def test_kernels_without_backward_refuse_grad(name):
    """Where a gradient is wanted the wrapper raises NotImplementedError
    before checking the device (so the CPU shows it); under no_grad the
    same call reaches the device check instead."""
    call = _guarded_calls()[name]
    with pytest.raises(NotImplementedError, match="backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="must be a CUDA tensor"):
        call()


def test_differentiable_kernels_take_grad_to_the_device_check():
    """fused_rmsnorm and uncapped flash_attention do not refuse a gradient:
    they go on to their checks (a CPU tensor is refused as such)."""
    x = torch.zeros(4, 64, requires_grad=True)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        rn.fused_rmsnorm_cuda(x, torch.zeros(64))
    q = torch.zeros(2, 8, 64, requires_grad=True)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.flash_attention_cuda(q, q, q)
