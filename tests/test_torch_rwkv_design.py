"""The arithmetic of the rwkv6_scan kernel's design, on the CPU.

``csrc/rwkv6_scan.cu`` runs only on the card. Here its algorithm is
emulated in plain PyTorch -- chunks of T steps (a short last chunk where
T does not divide S), per key channel the prefix products
``a_i = prod_{m<i} w_m``, the suffix products ``b_j = prod_{j<m<n} w_m``
and the total ``g``, the pairwise decays ``D_ij = prod_{j<m<i} w_m`` as a
running product along i, and the f32 state carried across chunks:

    A[i][j] = sum_d r_i[d] k_j[d] D_ij[d]  (j < i),  A[i][i] = r_i . (u k_i)
    o_i     = (r_i a_i) S0 + sum_{j<=i} A[i][j] v_j
    S       <- diag(g) S0 + sum_j (k_j b_j)^T v_j

-- and held against the plain version of the port and against the JAX
oracles (``repro.kernels.ref.rwkv6_scan_ref`` for o,
``repro.models.rwkv._time_mix_sequential`` for the final state) on
inputs drawn with numpy from a seed, at f32 2e-5
(``tests/test_kernels.py:23``). Every decay is a product of w's in
[0, 1], so none can overflow; the e^{-c} factorisation of JAX's
``_time_mix_chunked`` overflows f32 without the model's clamp.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain  # noqa: E402

F32_TOL = 2e-5           # tests/test_kernels.py:23
BH, NU = 4, 2            # u rows shared by the batch: row bh reads bh % NU


def rwkv_chunked_emulated(r, k, v, w, u, *, T):
    """The kernel's chunked product form. Returns o (BH, S, hd) in r's
    dtype and the final state (BH, hd, hd) f32 [key][value]."""
    bh, S, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float().repeat(bh // u.shape[0], 1)               # (BH, hd)
    state = torch.zeros(bh, hd, hd)
    o = torch.empty(bh, S, hd)
    for t0 in range(0, S, T):
        n = min(T, S - t0)                                   # short last chunk
        rc, kc, vc, wc = (t[:, t0:t0 + n] for t in (rf, kf, vf, wf))
        a = torch.ones(bh, n, hd)
        for i in range(1, n):
            a[:, i] = a[:, i - 1] * wc[:, i - 1]
        b = torch.ones(bh, n, hd)
        for j in range(n - 2, -1, -1):
            b[:, j] = b[:, j + 1] * wc[:, j + 1]
        g = b[:, 0] * wc[:, 0]
        A = torch.zeros(bh, n, n)
        for j in range(n):
            A[:, j, j] = (rc[:, j] * uf * kc[:, j]).sum(-1)
            D = torch.ones(bh, hd)                           # D_{j+1, j}
            for i in range(j + 1, n):
                A[:, i, j] = (rc[:, i] * (kc[:, j] * D)).sum(-1)
                D = D * wc[:, i]
        o[:, t0:t0 + n] = (rc * a) @ state + A @ vc
        state = g[:, :, None] * state + (kc * b).transpose(1, 2) @ vc
    return o.to(r.dtype), state


def draw(rng, S, hd, *, w=None):
    r, k, v = (torch.from_numpy(
        (0.3 * rng.standard_normal((BH, S, hd))).astype(np.float32))
        for _ in range(3))
    if w is None:
        w = torch.sigmoid(torch.from_numpy(
            rng.standard_normal((BH, S, hd)).astype(np.float32)))
    u = torch.from_numpy((0.1 * rng.standard_normal((NU, hd)))
                         .astype(np.float32))
    return r, k, v, w, u


def within(out, plain, tol=F32_TOL):
    assert bool(out.isfinite().all())
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= tol * (1 + plain.float().abs())).all()), \
        float(diff.max())


@functools.lru_cache(maxsize=None)
def jax_oracle(S, hd):
    """o from rwkv6_scan_ref and the final state from the model's
    sequential time-mix (BH = 2 sequences x NU heads), on the inputs
    ``draw`` makes for (S, hd)."""
    r, k, v, w, u = draw(np.random.default_rng(S * 1000 + hd), S, hd)
    u_rows = u.repeat(BH // NU, 1)
    o = ref.rwkv6_scan_ref(*(jnp.asarray(t.numpy())
                             for t in (r, k, v, w, u_rows)))

    def heads(t):   # (B * nh, S, hd) -> (B, S, nh, hd)
        return jnp.asarray(t.view(BH // NU, NU, S, hd).transpose(1, 2)
                       .numpy())

    s_final, _ = jrwkv._time_mix_sequential(
        {"u": jnp.asarray(u.numpy())}, heads(r), heads(k), heads(v),
        heads(torch.log(w)), jnp.zeros((BH // NU, NU, hd, hd), jnp.float32))
    return (torch.from_numpy(np.array(o)),
            torch.from_numpy(np.array(s_final)).view(BH, hd, hd))


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 33, 513])
def test_rwkv_chunked_design_matches_plain_and_ref(S, T, hd):
    r, k, v, w, u = draw(np.random.default_rng(S * 1000 + hd), S, hd)
    o, st = rwkv_chunked_emulated(r, k, v, w, u, T=T)
    o_plain, st_plain = rwkv6_scan_plain(r, k, v, w, u)
    within(o, o_plain)
    within(st, st_plain)
    o_ref, st_ref = jax_oracle(S, hd)
    within(o, o_ref)
    within(st, st_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_chunked_design_takes_w_at_the_ends_of_its_range(dtype):
    """w holding exact 0s, 1s, 1e-30 and 1 - 2^-24 (and 1e-3 for whole
    chunks): the product form stays finite and matches the plain version,
    while the e^{-c} factorisation of _time_mix_chunked overflows f32 at
    w = 1e-3 over 16 steps."""
    rng = np.random.default_rng(11)
    S, hd = 70, 64
    picks = np.array([0.0, 1.0, 1e-30, 1.0 - 2.0 ** -24, 1e-3], np.float32)
    w = torch.from_numpy(picks[rng.integers(0, len(picks), (BH, S, hd))])
    w[0, :32] = 1e-3                     # two whole chunks of 1e-3
    w[1, :, :8] = 0.0                    # channels that forget every step
    w[2, :, :8] = 1.0                    # channels that never forget
    r, k, v, _, u = draw(rng, S, hd, w=w)
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    tol = F32_TOL if dtype == torch.float32 else 2e-2
    for T in (16, 32):
        o, st = rwkv_chunked_emulated(r, k, v, w, u, T=T)
        o_plain, st_plain = rwkv6_scan_plain(r, k, v, w, u)
        within(o, o_plain, tol)
        within(st, st_plain)
    cum = torch.cumsum(torch.log(torch.full((16,), 1e-3)), 0)
    assert bool(torch.isinf(torch.exp(-cum)).any())
