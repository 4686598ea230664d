"""The arithmetic of the bf16 ssm_scan kernel's design, on the CPU.

``csrc/ssm_scan.cu``'s ``ssm_tc_kernel`` (bf16 B/C) runs only on the
card. Here its algorithm is emulated in plain PyTorch -- tiles of 64
steps that start again at every model-chunk start, c0 the cumulative
log-decay before the tile, ``G = C B^T`` masked (j <= i) before the
exponent, ``Y = P X + diag(exp(cum - c0)) C H^T``, the state carried in
f32 -- and held against the plain version of the port and against the
JAX oracle ``repro.kernels.ref.ssm_scan_ref`` on inputs drawn with numpy
from a seed: exactly and with the kernel's 3xTF32 products (each f32
operand split into two TF32 terms, round to nearest on 10 mantissa bits)
at 2e-4, the tolerance of ``tests/test_kernels.py:87``, and with one TF32
rounding of every product's operands at the bf16 kernel tolerance
2e-2 * (1 + |plain|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    chunk_cumsum, ssm_scan_plain)

TILE = 64                # steps a tile (kTcT)
EXACT_TOL = 2e-4         # tests/test_kernels.py:87
BF16_TOL = 2e-2          # |kernel - plain| <= TOL * (1 + |plain|), chip_smoke


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32: add half an ulp of TF32 to the
    magnitude's bits and clear the 13 low bits."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as TF32 hi + lo (the kernel's tf32_split): lo rounds the rest."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def product(a: torch.Tensor, b: torch.Tensor, rounding: str) -> torch.Tensor:
    """a @ b as the kernel's mma.sync takes it: exact, one TF32 rounding
    of each operand, or 3xTF32 (hi*hi + hi*lo + lo*hi; a bf16 operand's
    lo term is 0, so its product has two terms, as in the kernel)."""
    if rounding == "exact":
        return a @ b
    if rounding == "tf32":
        return tf32(a) @ tf32(b)
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def tiles(S: int, chunk: int) -> list[tuple[int, int]]:
    """The kernel's tiles (tile_end): at most 64 steps, never across a
    chunk start."""
    out, t0 = [], 0
    while t0 < S:
        t1 = min(t0 + TILE, (t0 // chunk + 1) * chunk, S)
        out.append((t0, t1))
        t0 = t1
    return out


def ssm_tc_emulated(xbar, B, C, cumlog, *, chunk, rounding):
    """ssm_tc_kernel's arithmetic. ``rounding`` ("exact", "tf32" or
    "tf32x3", the kernel's) is how each product takes its operands (bf16
    B/C are exact in TF32; xbar, P, H and X o decay are not); G = C B^T
    is exact (bf16 products, f32 sums) and the state H itself stays f32."""
    BH, S, hd = xbar.shape
    ds = B.shape[-1]
    group = BH // B.shape[0]
    Bf = B.float().repeat_interleave(group, dim=0)
    Cf = C.float().repeat_interleave(group, dim=0)
    cum = cumlog.float()
    H = torch.zeros(BH, hd, ds)
    y = torch.empty(BH, S, hd)
    for t0, t1 in tiles(S, chunk):
        n = t1 - t0
        c0 = cum[:, t0 - 1] if t0 % chunk else torch.zeros(BH)
        cm, X = cum[:, t0:t1], xbar[:, t0:t1].float()
        Bt, Ct = Bf[:, t0:t1], Cf[:, t0:t1]
        G = Ct @ Bt.transpose(1, 2)
        # mask before the exponent: above the diagonal exp may overflow
        lower = torch.tril(torch.ones(n, n, dtype=torch.bool))
        diff = torch.where(lower, cm[:, :, None] - cm[:, None, :], 0.0)
        P = torch.where(lower, G * torch.exp(diff), 0.0)
        inter = product(Ct, H.transpose(1, 2), rounding) * \
            torch.exp(cm - c0[:, None])[..., None]
        y[:, t0:t1] = inter + product(P, X, rounding)
        last = cm[:, -1:]
        Xd = X * torch.exp(last - cm)[..., None]
        H = H * torch.exp(last - c0[:, None])[..., None] + \
            product(Xd.transpose(1, 2), Bt, rounding)
    return y, H


def draw(rng, bh, bh_bc, S, hd, ds, chunk, *, decay=0.2):
    xbar = torch.from_numpy(
        (0.5 * rng.standard_normal((bh, S, hd))).astype(np.float32))
    B, C = (torch.from_numpy((0.5 * rng.standard_normal((bh_bc, S, ds)))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    loga = torch.from_numpy(
        -np.abs(decay * rng.standard_normal((bh, S))).astype(np.float32))
    return xbar, B, C, chunk_cumsum(loga, chunk)


def within(out, plain, tol):
    assert bool(out.isfinite().all())
    diff = (out - plain).abs()
    assert bool((diff <= tol * (1 + plain.abs())).all()), float(diff.max())


CASES = [  # bh, bh_bc, S, hd, ds, chunk
    (2, 2, 64, 64, 64, 16),      # chunk 16: tiles of 16
    (2, 1, 77, 64, 64, 77),      # chunk = S = 77, not a multiple of 64
    (2, 1, 600, 64, 64, 256),    # chunks 256, 256, 88: tiles 64 ... 24
    (2, 2, 1, 64, 64, 1),        # S 1
    (3, 3, 40, 32, 64, 1),       # chunk 1: every tile one step
    (4, 2, 128, 64, 64, 64),     # BH 4 over 2 B/C groups
    (2, 1, 96, 64, 16, 32),      # ds 16
    (2, 1, 130, 32, 32, 130),    # ds 32, hd 32
    (2, 1, 200, 128, 128, 100),  # ds 128, hd 128
]


@pytest.mark.parametrize("rounding", ["exact", "tf32", "tf32x3"])
@pytest.mark.parametrize("bh,bh_bc,S,hd,ds,chunk", CASES)
def test_ssm_tc_design_matches_plain_and_ref(bh, bh_bc, S, hd, ds, chunk,
                                             rounding):
    rng = np.random.default_rng(S * 1000 + ds + chunk)
    xbar, B, C, cum = draw(rng, bh, bh_bc, S, hd, ds, chunk)
    y, h = ssm_tc_emulated(xbar, B, C, cum, chunk=chunk, rounding=rounding)
    y_plain, h_plain = ssm_scan_plain(xbar, B, C, cum, chunk=chunk)
    tol = BF16_TOL if rounding == "tf32" else EXACT_TOL
    within(y, y_plain, tol)
    within(h, h_plain, tol)
    if S % chunk == 0:           # the oracle takes whole chunks only
        group = bh // bh_bc
        y_ref = ref.ssm_scan_ref(
            jnp.asarray(xbar.numpy()),
            jnp.asarray(B.float().repeat_interleave(group, 0).numpy()),
            jnp.asarray(C.float().repeat_interleave(group, 0).numpy()),
            jnp.asarray(cum.numpy()), chunk=chunk)
        within(y, torch.from_numpy(np.array(y_ref)), tol)


def test_ssm_tc_tf32_rounding_is_visible_and_bounded():
    """The TF32 emulation does change the result (so the rounded case
    tests something) by no more than a few TF32 ulps of the output."""
    rng = np.random.default_rng(7)
    xbar, B, C, cum = draw(rng, 2, 1, 600, 64, 64, 256)
    y_exact, _ = ssm_tc_emulated(xbar, B, C, cum, chunk=256,
                                 rounding="exact")
    y_tf32, _ = ssm_tc_emulated(xbar, B, C, cum, chunk=256,
                                rounding="tf32")
    rel = float(((y_tf32 - y_exact).abs() / (1 + y_exact.abs())).max())
    assert 1e-6 < rel < 5e-3, rel


def test_ssm_tc_3xtf32_recovers_f32():
    """One TF32 rounding of the operands misses the 2e-4 tolerance at
    zamba2's shape of one head group (so the kernel splits them); the
    kernel's 3xTF32 products land within a tenth of it, 30x closer."""
    rng = np.random.default_rng(7)
    xbar, B, C, cum = draw(rng, 64, 1, 600, 64, 64, 256)
    y_exact, h_exact = ssm_tc_emulated(xbar, B, C, cum, chunk=256,
                                       rounding="exact")

    def rel(rounding):
        y, h = ssm_tc_emulated(xbar, B, C, cum, chunk=256, rounding=rounding)
        return max(float(((a - b).abs() / (1 + b.abs())).max())
                   for a, b in ((y, y_exact), (h, h_exact)))

    one, three = rel("tf32"), rel("tf32x3")
    assert one > EXACT_TOL, one
    assert three < EXACT_TOL / 10 and 30 * three < one, (three, one)


def test_ssm_tc_masks_before_the_exponent():
    """With a steep decay, exp(cum_i - cum_j) above the diagonal
    overflows to inf; masking by a product would give inf * 0 = NaN,
    the design's select before the exponent stays finite and exact."""
    rng = np.random.default_rng(3)
    xbar, B, C, cum = draw(rng, 2, 1, 64, 64, 64, 64, decay=60.0)
    cm = cum[:, :TILE]
    above = torch.exp(cm[:, :, None] - cm[:, None, :])
    assert bool(torch.isinf(above).any())
    lower = torch.tril(torch.ones(TILE, TILE, dtype=torch.bool))
    assert bool(torch.isnan(above * lower).any())
    y, h = ssm_tc_emulated(xbar, B, C, cum, chunk=64, rounding="exact")
    y_plain, h_plain = ssm_scan_plain(xbar, B, C, cum, chunk=64)
    within(y, y_plain, EXACT_TOL)
    within(h, h_plain, EXACT_TOL)


@pytest.mark.parametrize("S,chunk", [(1, 1), (64, 16), (77, 77),
                                     (600, 256), (513, 256), (130, 64),
                                     (200, 100), (40, 1)])
def test_ssm_tc_tiles_never_span_a_chunk(S, chunk):
    ts = tiles(S, chunk)
    assert ts[0][0] == 0 and ts[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ts, ts[1:]))
    for t0, t1 in ts:
        assert 1 <= t1 - t0 <= TILE
        assert t0 // chunk == (t1 - 1) // chunk   # one chunk per tile
    # every chunk start begins a tile (c0 = 0 there)
    starts = {t0 for t0, _ in ts}
    assert all(c in starts for c in range(0, S, chunk))
