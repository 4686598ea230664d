"""Gradients of the port's norm and attention on the CPU.

* The plain versions' gradients (autograd) against ``jax.grad`` of the
  JAX references (``repro.kernels.ref`` and the model's
  ``flash_attention_xla``) at hd 64, 128, 168 and 240, GQA, windows and
  ragged S.
* A design test of the backward kernels (``csrc/fused_rmsnorm.cu``'s
  backward, ``csrc/flash_attention_bwd.cu``): their tiling, the tiles
  they skip and their fixed reduction orders emulated in PyTorch, run
  through the autograd Functions on the CPU with the kernels replaced by
  the emulation, against autograd through the plain versions. The flash
  backward's emulation is routed as ``launch_hd`` dispatches: bf16 at
  every hd to the tensor-core kernels' (64-key and 64-row tiles, the
  dkdv block's query sub-steps and the dq block's key sub-steps, hd 168
  padded to 176 with zero columns, P in the exp2 domain, P and dS
  rounded to bf16 before their products, f32 sums; also held against
  ``jax.grad`` of ``flash_attention_xla``), f32 to the SIMT kernels'
  (32-row query and 32-key tiles). Both sum dK/dV over the G query heads
  of a KV head and the query tiles in order, dQ separately over the key
  tiles. The norm's dw is a partial row a block of contiguous rows (its
  row groups summed in order), then the partials by warp, then the warps
  in order. The tensor-core kernels' shared-memory layout and skipped
  tiles are checked too. Keep the emulation in step with the .cu files.
* The guards: ``decode_attention`` and a capped ``flash_attention``
  refuse a gradient in their CUDA wrappers, before any device check;
  the four differentiable kernels (``fused_rmsnorm``, ``flash_attention``,
  ``ssm_scan``, ``rwkv6_scan``) go on to it.

Tolerances: f32 2e-5 (tests/test_kernels.py:23) for elementwise outputs;
dw, a sum over N rows, at 2e-5 * sqrt(N) (the rounding of a sum of N
unit-scale f32 terms grows as sqrt(N) in any order); bf16 2e-2 * (1 +
|reference|), the card's kernel tolerance (chip_smoke.py's TOL).
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
BF16_TOL = 2e-2        # |kernel - reference| <= BF16_TOL * (1 + |reference|)
TILE = 32              # the SIMT kernels' query rows and keys a tile
TC_TILE = 64           # the tensor-core kernels' rows a tile
TC_HEAD_DIMS = (16, 32, 64, 128, 168, 240)   # bf16 head dims (all of them)
LOG2E = np.float32(1.4426950408889634)
H100_SMEM_PER_BLOCK = 232448       # bytes of dynamic shared memory a block
H100_SMEM_PER_SM = 233472          # 228 KB, 1 KB of it reserved a block
DW_WARPS = 8                       # warps a block of the norm's dw pass
BWD_VECS = 4      # 16-byte vectors of x, and of dy, a thread (kBwdVecs)


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

def bwd_layout(n: int, d: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """The norm backward's row pass as ``launch_bwd`` lays it out for
    16-byte aligned tensors: (rows a block, blocks, row groups a block).
    A block takes a contiguous range of ceil(n / BWD_BLOCKS) rows; on the
    register path (d a multiple of the 16-byte vector, d <= 256 threads x
    BWD_VECS vectors) its 256 threads hold 256 / TPR row groups of TPR
    threads, TPR the least of 32, 64, 128, 256 that covers d, group k
    taking rows k, k + groups, ...; on the looping path the block is one
    group of its rows in order."""
    rows = -(-n // rn.BWD_BLOCKS)
    blocks = -(-n // rows)
    vec = 16 // (torch.finfo(dtype).bits // 8)   # elements a vector
    if d % vec == 0:
        for tpr in (32, 64, 128, 256):
            if d <= tpr * BWD_VECS * vec:
                return rows, blocks, 256 // tpr
    return rows, blocks, 1


def emulate_rmsnorm_bwd(x, w, dy, eps=1e-6):
    """rmsnorm_bwd_{rows,loop}_kernel then rmsnorm_bwd_dw_kernel, laid out
    by ``bwd_layout``: r and the row's coefficient b r^3 / d; each block's
    contiguous rows in its row groups (group k the rows k, k + groups, ...
    of the block, each summed in row order), the groups summed in group
    order into the block's partial row; then warp k of the dw pass sums
    partials k, k + 8, ... in order, and the 8 warp sums in warp order."""
    n, d = x.shape
    xf, g = x.float(), dy.float()
    wc = 1.0 + w
    r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    coef = (g * wc * xf).sum(-1, keepdim=True) * r ** 3 / d
    dx = (r * wc * g - xf * coef).to(x.dtype)
    rows, blocks, groups = bwd_layout(n, d, x.dtype)
    partials = []
    for b in range(blocks):
        start, end = b * rows, min(b * rows + rows, n)
        part = None
        for k in range(groups):
            acc = torch.zeros(d)
            for i in range(start + k, end, groups):
                acc = acc + g[i] * xf[i] * r[i]
            part = acc if part is None else part + acc
        partials.append(part)
    dw = torch.zeros(d)
    for k in range(DW_WARPS):
        s = torch.zeros(d)
        for p in partials[k::DW_WARPS]:
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


# -- the tensor-core backward (bf16, every hd) --------------------------------

def tc_layout(hd):
    """BwdTcLayout<hd>: (row stride in bf16, dkdv bytes, dq bytes, query
    columns of a dkdv sub-step, padded columns, warps a dkdv 16-key
    slice, keys of a dq sub-step)."""
    pad = -(-hd // 16) * 16
    stride = pad + 8
    tiles = 6 * TC_TILE * stride * 2
    split = 2 if pad > 128 else 1
    nk = 16 if pad > 176 else 32 if pad > 128 else 64
    return (stride, tiles + 2 * 2 * TC_TILE * 4, tiles, 32 if hd > 64 else 64,
            pad, split, nk)


def dkdv_tc_tiles(sq, sk, causal, window):
    """flash_bwd_dkdv_tc_kernel's (key tile k0, [query tiles q0]) in the
    order a block visits them: q >= k0 (causal), q < k_max + W (window)."""
    for k0 in range(0, sk, TC_TILE):
        k_max = min(k0 + TC_TILE, sk) - 1
        q_lo = k0 if causal else 0
        q_hi = min(sq, k_max + window) if window > 0 else sq
        yield k0, list(range(q_lo, q_hi, TC_TILE))


def dq_tc_tiles(sq, sk, causal, window):
    """flash_bwd_dq_tc_kernel's (query tile q0, [key tiles kt]): keys up to
    the tile's last row (causal), from the 64-key tile holding q0 - W + 1
    (window)."""
    for q0 in range(0, sq, TC_TILE):
        q_last = min(q0 + TC_TILE, sq) - 1
        k_end = min(sk, q_last + 1) if causal else sk
        k_begin = (max(0, q0 - window + 1) if window > 0 else 0) \
            // TC_TILE * TC_TILE
        yield q0, list(range(k_begin, k_end, TC_TILE))


def _tc_mask(q0, k0, sq, sk, causal, window, rows):
    """The (64 query, 64 key) mask of a tile pair, or None where the
    kernel applies none: only a tile past S, on the causal diagonal or on
    the window edge masks per element. ``rows``: query rows past sq are
    masked too (dkdv, which sums over them; dq never stores them)."""
    B = TC_TILE
    need = ((rows and q0 + B > sq) or k0 + B > sk
            or (causal and k0 + B - 1 > q0)
            or (window > 0 and k0 <= q0 + B - 1 - window))
    if not need:
        return None
    qi = torch.arange(q0, q0 + B)[:, None]
    key = torch.arange(k0, k0 + B)[None, :]
    ok = (key < sk) & ((qi < sq) if rows else torch.ones(B, 1, dtype=bool))
    if causal:
        ok &= key <= qi
    if window > 0:
        ok &= key > qi - window
    return ok


def _tile(t, r0, n=TC_TILE, cols=None):
    """Rows r0 .. r0 + n - 1 of t (..., rows[, hd]) in f32, zero past the
    end, and with ``cols`` the columns zero from hd to ``cols`` (cp.async's
    zero-fill of the rows past S and of the pad columns)."""
    part = t[:, r0:r0 + n].float()
    pad = [0, 0] * (t.dim() - 2) + [0, n - part.shape[1]]
    if cols is not None:
        pad[1] = cols - t.shape[-1]
    return torch.nn.functional.pad(part, pad)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def emulate_dkdv_tc(q, k, v, do, lse, delta, *, causal=True, window=0):
    """flash_bwd_dkdv_tc_kernel: a block per (KV head, 64-key tile), here
    every KV head at once; tiles of ``tc_layout(hd)[4]`` columns (hd 168
    padded to 176 with zeros); for each of the G query heads in order its
    query tiles in order, each in sub-steps of ``tc_layout(hd)[3]`` query
    columns: S^T = K Q^T and dP^T = V dO^T of bf16 values in f32, P^T =
    exp2(S^T scale log2(e) - lse log2(e)) (0 where the tile's mask drops
    a pair), dS^T = P^T (dP^T - D); dV += bf16(P^T) dO and dK += bf16(dS^T)
    Q in f32; dK scaled once at the store, no pad column stored. Above hd
    128 a key slice's two warps each own half of dK and dV's columns but
    both form the whole S^T and dP^T, so the sums are the one-warp
    design's."""
    BH, sq, hd = q.shape
    bh_kv, sk, _ = k.shape
    G = BH // bh_kv
    scale = float(np.float32(1) / np.sqrt(np.float32(hd)))
    scale_log2 = float(LOG2E / np.sqrt(np.float32(hd), dtype=np.float32))
    _, _, _, nq, cols, _, _ = tc_layout(hd)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for k0, q_tiles in dkdv_tc_tiles(sq, sk, causal, window):
        kt, vt = _tile(k, k0, cols=cols), _tile(v, k0, cols=cols)
        dk_acc, dv_acc = torch.zeros(kt.shape), torch.zeros(vt.shape)
        for g in range(G):
            heads = torch.arange(bh_kv) * G + g
            for q0 in q_tiles:
                qt = _tile(q[heads], q0, cols=cols)
                dot = _tile(do[heads], q0, cols=cols)
                lt, dt = _tile(lse[heads], q0), _tile(delta[heads], q0)
                ok = _tc_mask(q0, k0, sq, sk, causal, window, rows=True)
                for c0 in range(0, TC_TILE, nq):
                    sub = slice(c0, c0 + nq)
                    qs, dos = qt[:, sub], dot[:, sub]
                    st = kt @ qs.transpose(1, 2)
                    dpt = vt @ dos.transpose(1, 2)
                    p = torch.exp2(st * scale_log2
                                   - (lt[:, None, sub] * float(LOG2E)))
                    if ok is not None:
                        p = torch.where(ok[sub].T, p, 0.0)
                    ds = p * (dpt - dt[:, None, sub])
                    dv_acc += _bf16(p) @ dos
                    dk_acc += _bf16(ds) @ qs
        n = min(TC_TILE, sk - k0)
        dk[:, k0:k0 + n] = (dk_acc * scale)[:, :n, :hd]
        dv[:, k0:k0 + n] = dv_acc[:, :n, :hd]
    return dk.to(k.dtype), dv.to(v.dtype)


def emulate_dq_tc(q, k, v, do, lse, delta, *, causal=True, window=0):
    """flash_bwd_dq_tc_kernel: a block per (query head, 64-row tile), here
    every head at once; tiles of ``tc_layout(hd)[4]`` columns (hd 168
    padded with zeros); the key tiles in order, each in sub-steps of
    ``tc_layout(hd)[6]`` keys (32 at hd 168, 16 at 240): S = Q K^T, dP = dO V^T,
    P = exp2(S scale log2(e) - lse log2(e)), 0 where masked, dS = P (dP -
    D), dQ += bf16(dS) K in f32, scaled at the store, no pad column
    stored."""
    BH, sq, hd = q.shape
    G = BH // k.shape[0]
    scale = float(np.float32(1) / np.sqrt(np.float32(hd)))
    scale_log2 = float(LOG2E / np.sqrt(np.float32(hd), dtype=np.float32))
    _, _, _, _, cols, _, nk = tc_layout(hd)
    kf, vf = (t.repeat_interleave(G, dim=0) for t in (k, v))
    sk = k.shape[1]
    dq = torch.zeros(q.shape)
    for q0, k_tiles in dq_tc_tiles(sq, sk, causal, window):
        qt, dot = _tile(q, q0, cols=cols), _tile(do, q0, cols=cols)
        lse2 = _tile(lse, q0) * float(LOG2E)
        dt = _tile(delta, q0)
        acc = torch.zeros(qt.shape)
        for kt in k_tiles:
            kk, vv = _tile(kf, kt, cols=cols), _tile(vf, kt, cols=cols)
            ok = _tc_mask(q0, kt, sq, sk, causal, window, rows=False)
            for c0 in range(0, TC_TILE, nk):
                sub = slice(c0, c0 + nk)
                p = torch.exp2(qt @ kk[:, sub].transpose(1, 2) * scale_log2
                               - lse2[..., None])
                if ok is not None:
                    p = torch.where(ok[:, sub], p, 0.0)
                ds = p * (dot @ vv[:, sub].transpose(1, 2) - dt[..., None])
                acc += _bf16(ds) @ kk[:, sub]
        n = min(TC_TILE, sq - q0)
        dq[:, q0:q0 + n] = (acc * scale)[:, :n, :hd]
    return dq.to(q.dtype)


def on_tensor_cores(q):
    """launch_hd's rule: bf16 runs the tensor-core kernels at every hd,
    f32 the SIMT ones."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS


def dispatch_dkdv(q, *args, **kw):
    return (emulate_dkdv_tc if on_tensor_cores(q) else emulate_dkdv)(
        q, *args, **kw)


def dispatch_dq(q, *args, **kw):
    return (emulate_dq_tc if on_tensor_cores(q) else emulate_dq)(
        q, *args, **kw)


@pytest.fixture
def emulated_kernels(monkeypatch):
    """The Functions' kernels replaced by the plain forward (with the
    plain log-sum-exp) and the emulated backward, routed by (dtype, hd)
    as the card's dispatch routes them, so that the autograd wiring of
    the card runs on CPU tensors."""
    def flash_forward(q, k, v, causal, window, softcap, out, lse):
        out.copy_(fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window))
        if lse is not None:
            lse.copy_(fa.flash_lse_plain(q, k, causal=causal, window=window))
        return out
    monkeypatch.setattr(fa, "_forward", flash_forward)
    monkeypatch.setattr(fa, "flash_bwd_preprocess_cuda",
                        fa.flash_bwd_preprocess_plain)
    monkeypatch.setattr(fa, "flash_bwd_dkdv_cuda", dispatch_dkdv)
    monkeypatch.setattr(fa, "flash_bwd_dq_cuda", dispatch_dq)
    monkeypatch.setattr(rn, "_forward",
                        lambda x, w, eps: rn.fused_rmsnorm_plain(x, w, eps=eps))
    monkeypatch.setattr(rn, "fused_rmsnorm_bwd_cuda",
                        lambda x, w, dy, eps: emulate_rmsnorm_bwd(x, w, dy,
                                                                  eps))


# d 3840, 4096, 5376 (gemma3-12b, deepseek-7b, gemma3-27b) at row counts
# that leave a last block short: 601 = 200 x 3 + 1, 1001 = 250 x 4 + 1,
# 533 = 177 x 3 + 2
@pytest.mark.parametrize("n,d", [(1, 4096), (77, 64), (1000, 48), (16, 8),
                                 (601, 3840), (1001, 4096), (533, 5376)])
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


@pytest.mark.parametrize("n", [1, 263, 264, 265, 529, 8192, 100_003])
def test_rmsnorm_backward_blocks_fit_the_partial_rows(n):
    """The row pass's blocks cover the n rows, each block holds at least
    one, and there are never more than the BWD_BLOCKS partial rows the
    wrapper allocates."""
    rows, blocks, _ = bwd_layout(n, 4096, torch.bfloat16)
    assert 1 <= blocks <= rn.BWD_BLOCKS
    assert (blocks - 1) * rows < n <= blocks * rows


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


# (bh, bh_kv, sq, sk, hd, causal, window), bf16: GQA (G = 2, 3), windows
# across and inside a 64 tile, S 1, 63, 65, 130, Sq != Sk, non-causal,
# every head dim; hd 168 (padded to 176) and 240 (two warps a dkdv key
# slice, 32-key dq sub-steps) with G = 2, windows and S ragged across
# the 64-row tiles
TC_DESIGN = [(4, 4, 130, 130, 128, True, 0), (6, 3, 77, 77, 64, True, 0),
             (6, 2, 65, 65, 32, True, 0), (2, 2, 200, 200, 16, True, 100),
             (3, 3, 130, 130, 64, True, 20), (2, 2, 1, 1, 128, True, 0),
             (2, 2, 63, 63, 32, True, 0), (4, 2, 64, 150, 16, False, 0),
             (2, 1, 130, 70, 128, True, 0), (2, 2, 70, 130, 64, True, 0),
             (3, 3, 31, 31, 16, False, 8), (2, 2, 65, 65, 168, True, 0),
             (4, 2, 40, 40, 240, True, 0), (4, 2, 150, 150, 168, True, 40),
             (4, 2, 130, 130, 240, True, 20), (4, 2, 70, 140, 240, True, 0),
             (4, 2, 97, 97, 168, False, 0)]


@pytest.mark.parametrize("bh,bh_kv,sq,sk,hd,causal,window", TC_DESIGN)
def test_flash_tc_backward_design_matches_plain_and_jax(
        emulated_kernels, bh, bh_kv, sq, sk, hd, causal, window):
    """bf16 through the autograd Function, the backward routed as the card
    routes it, against autograd through the plain version on the same
    bf16 inputs and against jax.grad of the JAX model's
    flash_attention_xla on their f32 values, at 2e-2 (1 + |reference|)."""
    rng = np.random.default_rng(bh * 1000 + sq * 7 + sk + hd)
    shapes = ((bh, sq, hd), (bh_kv, sk, hd), (bh_kv, sk, hd), (bh, sq, hd))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(torch.bfloat16) for sh in shapes)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.FlashAttention.apply(qg, kg, vg, causal, window).backward(do)
    got = (qg.grad, kg.grad, vg.grad)
    plain = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal,
                                         window=window)
    G = bh // bh_kv
    jq, jk, jv, jdo = (t.float().numpy() for t in (q, k, v, do))

    def f(q, k, v):
        out = flash_attention_xla(q.reshape(1, bh_kv, G, sq, hd), k[None],
                                  v[None], causal=causal, window=window,
                                  q_block=64, k_block=64)
        return jnp.sum(out.reshape(bh, sq, hd) * jdo)
    oracle = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    for g, p, o in zip(got, plain, oracle):
        assert g.dtype == torch.bfloat16
        for ref in (p.float(), torch.from_numpy(np.array(o))):
            diff = (g.float() - ref).abs()
            assert bool(g.float().isfinite().all())
            assert bool((diff <= BF16_TOL * (1 + ref.abs())).all()), \
                float(diff.max())


def test_flash_tc_backward_rounds_p_and_ds_to_bf16():
    """The tensor-core emulation differs from the SIMT one (f32 P and dS)
    by the bf16 rounding of P and dS alone: on the same f32-valued bf16
    inputs, both within the bf16 tolerance of the plain backward, but
    not equal."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 96, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    lse = fa.flash_lse_plain(q, k)
    delta = fa.flash_bwd_preprocess_plain(
        fa.flash_attention_plain(q, k, v), do)
    tc = emulate_dkdv_tc(q, k, v, do, lse, delta) + (
        emulate_dq_tc(q, k, v, do, lse, delta),)
    simt = emulate_dkdv(q, k, v, do, lse, delta) + (
        emulate_dq(q, k, v, do, lse, delta),)
    assert any(not torch.equal(a, b) for a, b in zip(tc, simt))
    for a, b in zip(tc, simt):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= BF16_TOL * (1 + b.float().abs())).all())


@pytest.mark.parametrize("hd", TC_HEAD_DIMS)
def test_flash_tc_backward_layout_is_conflict_free_and_fits(hd):
    """Each tensor-core backward kernel's smem rows are an odd count of
    16-byte units (the 8 rows an ldmatrix reads fall on distinct banks)
    and its bytes fit a block; at hd <= 128 two blocks fit an SM (six
    64 x 136 bf16 tiles at hd 128: 104,448 bytes, dkdv 1,024 more for lse
    and D) and a 64-row tile's chunks are whole rounds of the 128
    threads, above it one block an SM (hd 168 padded to 176: rows of 184;
    hd 240: rows of 248) whose 256 dkdv threads take guarded rounds; a
    dkdv sub-step takes 32 query columns above hd 64, 64 below; the f32
    accumulators a thread stay at or under hd 128's (dK and dV 128, S^T
    and dP^T 32): above hd 128 a key slice has two warps, each half of
    dK and dV's 16-column groups, and dq's sub-steps take 32 keys at hd
    168, 16 at hd 240."""
    stride, dkdv, dq, nq, pad, split, nk = tc_layout(hd)
    assert (stride * 2 // 16) % 2 == 1
    assert pad % 16 == 0 and 0 <= pad - hd < 16
    for nbytes in (dkdv, dq):
        assert nbytes <= H100_SMEM_PER_BLOCK
        blocks = 2 if hd <= 128 else 1
        assert blocks * (nbytes + 1024) <= H100_SMEM_PER_SM
    if hd <= 128:
        assert split == 1 and nk == TC_TILE
        assert TC_TILE * (hd // 8) % 128 == 0
    else:
        assert split == 2 and nk == (32 if hd == 168 else 16)
    assert TC_TILE % nq == 0 and nq % 16 == 0
    assert TC_TILE % nk == 0 and nk % 16 == 0
    groups = -(-(pad // 16) // split)          # dK/dV column groups a warp
    assert 2 * (2 * groups) * 4 + nq <= 160    # dkdv: dK, dV, S^T, dP^T
    assert pad // 2 + nk <= 160                # dq: dQ, S and dP
    if hd == 128:
        assert (stride, dkdv, dq, nq) == (136, 105472, 104448, 32)
    if hd == 168:
        assert (stride, pad, dkdv, dq) == (184, 176, 142336, 141312)
    if hd == 240:
        assert (stride, dkdv, dq, groups) == (248, 191488, 190464, 8)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (600, 600, True, 100), (600, 600, True, 0), (130, 70, True, 0),
    (70, 130, True, 0), (200, 200, True, 64), (150, 90, False, 30),
    (65, 65, False, 0)])
def test_flash_tc_backward_tiles_skip_only_dead_pairs(sq, sk, causal,
                                                      window):
    """The tile pairs the two tensor-core kernels never load hold no live
    (query, key) pair, and under a binding mask they skip some."""
    qi, ki = np.meshgrid(np.arange(sq), np.arange(sk), indexing="ij")
    live = np.ones((sq, sk), bool)
    if causal:
        live &= ki <= qi
    if window > 0:
        live &= ki > qi - window
    B = TC_TILE
    for tiles, kv_major in ((dkdv_tc_tiles(sq, sk, causal, window), True),
                            (dq_tc_tiles(sq, sk, causal, window), False)):
        visited = np.zeros((sq, sk), bool)
        for outer, inner in tiles:
            for i in inner:
                q0, k0 = (i, outer) if kv_major else (outer, i)
                visited[q0:q0 + B, k0:k0 + B] = True
        assert not (live & ~visited).any()
        if (causal or window) and min(sq, sk) > 2 * B:
            assert visited.sum() < sq * sk


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


def _differentiable_calls():
    x = torch.zeros(4, 64, requires_grad=True)
    q = torch.zeros(2, 8, 64, requires_grad=True)
    t = torch.zeros(2, 16, 16, requires_grad=True)
    return {
        "fused_rmsnorm": lambda: rn.fused_rmsnorm_cuda(x, torch.zeros(64)),
        "flash_attention": lambda: fa.flash_attention_cuda(q, q, q),
        "ssm_scan": lambda: ssm_scan_cuda(t, t, t, torch.zeros(2, 16),
                                          chunk=16),
        "rwkv6_scan": lambda: rwkv6_scan_cuda(t, t, t, t, torch.zeros(2, 16)),
    }


@pytest.mark.parametrize("name", list(_differentiable_calls()))
def test_differentiable_kernels_take_grad_to_the_device_check(name):
    """fused_rmsnorm, uncapped flash_attention, ssm_scan and rwkv6_scan do
    not refuse a gradient: they go on to their checks (a CPU tensor is
    refused as such)."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _differentiable_calls()[name]()
