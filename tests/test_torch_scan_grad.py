"""The arithmetic of the scans' backward kernels, on the CPU.

``csrc/ssm_scan_bwd.cu`` and ``csrc/rwkv6_scan_bwd.cu`` run only on the
card. Here each is emulated in plain PyTorch, step for step as the kernel
orders its work, and held against autograd through the port's plain
versions and against ``jax.grad`` of the JAX oracles
(``repro.kernels.ref.ssm_scan_ref`` / ``rwkv6_scan_ref``, which take B
and u a row, so both are repeated per head and JAX's gradients summed
back over the heads that share them), on inputs drawn with numpy from a
seed.

* ``ssm_scan``: the prep pass (each chunk's own state terms X^T
  diag(exp(tot - cum)) B and dY^T diag(exp(cum)) C over 64-step tiles,
  and C B^T once a B/C group), the carry over the chunks (the state at
  each chunk's start, its gradient at each chunk's end from dh), then a
  (head, chunk) at a time one sweep of 64-step tile pairs: the column
  tiles j in order, each against the row tiles i from the last down to
  j, dX and dB of tile j and dC and R's row sums of tile i added as the
  pairs come, the state terms once the pair (j, j) is done; the
  exponent's argument masked (j <= i) before exp; every product as the
  kernel's mma.sync takes it, each f32 operand split into its TF32 part
  and the rest (3xTF32). dB and dC are summed over a group's heads in
  order.
* ``rwkv6_scan``: each 64-step chunk's decay and what it adds to the
  state and to the state's gradient, as products of w; the carry over
  the chunks; then a chunk at a time its state stepped forward from the
  checkpoint and kept every 16 steps, the 16-step sub-chunks walked in
  reverse (states recomputed, dr on the way, dS carried back); dv is
  summed over the row blocks, du over the chunks and the heads of a u
  row.

Tolerances: f32 2e-5 (``tests/test_kernels.py:23``, ``TOL`` of
``tests/test_torch_grad.py``) for gradients of a few terms a step; a
gradient that sums n terms of unit scale (over the steps of a chunk,
the heads of a group, the rows of a state) at 2e-5 sqrt(n), the
``dw_tol`` of ``tests/test_torch_grad.py``: such a sum's rounding grows
as sqrt(n) in any order. Each check names its n.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels.ssm_scan import chunk_cumsum  # noqa: E402

F32_TOL = 2e-5           # tests/test_kernels.py:23
TILE = ss.BWD_TILE       # ssm_bwd_chunk_kernel's steps a tile (kT)
H100_SMEM_PER_BLOCK = 232448
H100_SMEM_PER_SM = 233472    # 228 KB, of which the hardware keeps 1 KB a block


def tf32_read(x):
    """What the tensor cores read of an f32 operand in TF32: its sign,
    exponent and top 10 mantissa bits (the low 13 bits are not read)."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF) \
        .view(torch.float32)


def product(a, b, rounding):
    """a @ b as ssm_scan_bwd.cu's mma.sync takes it: "exact"; "tf32", each
    operand read once in TF32; or "tf32x3", the kernel's, each operand
    split x = hi + lo exactly (hi = its TF32 part, lo the rest, read in
    TF32 in turn) and lo*hi + hi*lo + hi*hi summed (a bf16 operand's lo is
    0: its product has two terms, as in the kernel)."""
    if rounding == "exact":
        return a @ b
    if rounding == "tf32":
        return tf32_read(a) @ tf32_read(b)
    ah, bh = tf32_read(a), tf32_read(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread runs these as fast as eight, and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dw_tol(n):
    return F32_TOL * math.sqrt(n)


def within(out, want, tol):
    out, want = out.float(), want.float()
    assert bool(out.isfinite().all())
    diff = (out - want).abs()
    assert bool((diff <= tol * (1 + want.abs())).all()), float(diff.max())


def f32(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape))
                            .astype(np.float32))


# -- ssm_scan ---------------------------------------------------------------------

def ssm_prep_emulated(X, DY, Bg, Cg, cum, chunk, group, rounding):
    """ssm_bwd_prep_kernel: each chunk's own state terms U_c = X^T
    diag(exp(tot - cum)) B and V_c = dY^T diag(exp(cum)) C (BH, nc, hd,
    ds), summed tile by tile over the chunk's 64-step tiles, and C B^T of
    each (B/C group, chunk) once (exact products of bf16 B/C; 3xTF32 for
    f32)."""
    BH, S, hd = X.shape
    ds = Bg.shape[-1]
    nc = -(-S // chunk)
    Bh, Ch = (t.repeat_interleave(group, 0) for t in (Bg, Cg))
    U, V = torch.empty(BH, nc, hd, ds), torch.empty(BH, nc, hd, ds)
    CB = []
    for c in range(nc):
        t0, n = c * chunk, min(chunk, S - c * chunk)
        cm = cum[:, t0:t0 + n]
        e, f = torch.exp(cm[:, -1:] - cm), torch.exp(cm)
        u = v = 0
        for a in range(0, n, TILE):
            sl = slice(t0 + a, t0 + min(a + TILE, n))
            ws = slice(a, min(a + TILE, n))
            u = u + product((X[:, sl] * e[:, ws, None]).transpose(1, 2),
                            Bh[:, sl], rounding)
            v = v + product((DY[:, sl] * f[:, ws, None]).transpose(1, 2),
                            Ch[:, sl], rounding)
        U[:, c], V[:, c] = u, v
        CB.append(product(Cg[:, t0:t0 + n], Bg[:, t0:t0 + n].transpose(1, 2),
                          rounding))
    return U, V, CB


def ssm_carry_emulated(Z, cum, x0, chunk, reverse):
    """ssm_bwd_carry_kernel: X (BH, hd, ds) carried over the chunks (in
    reverse for the gradient), written at each chunk before its update
    X <- exp(tot) X + Z_c: the state at each chunk's start from U, its
    gradient at each chunk's end from V and dh. Returns (BH, nc, hd, ds)."""
    BH, nc = Z.shape[:2]
    S = cum.shape[1]
    out = torch.empty_like(Z)
    X = x0.clone()
    for c in (range(nc - 1, -1, -1) if reverse else range(nc)):
        tot = cum[:, min(S, (c + 1) * chunk) - 1]
        out[:, c] = X
        X = torch.exp(tot)[:, None, None] * X + Z[:, c]
    return out


def ssm_bwd_emulated(xbar, B, C, cumlog, dy, dh, *, chunk,
                     rounding="tf32x3"):
    """repro_ssm_scan_bwd's arithmetic: (dxbar, dB, dC, dcumlog). The
    prep and carry passes, then a (head, chunk) at a time one sweep of
    64-step tiles: the column tiles j in order, for each the row tiles i
    from the last down to j; a pair forms dP and takes C B^T once, adds
    P^T dY and M^T C into the column tile's dX, dB and M B and R's row
    sums into the row tile's dC and dcum; after the pair (j, j) the state
    terms finish tile j. Every product as the kernel's mma.sync takes it
    (``rounding``, test_torch_ssm_design.product: 3xTF32 in the kernel)."""
    BH, S, hd = xbar.shape
    bh_bc, _, ds = B.shape
    group = BH // bh_bc
    X, DY, cum = xbar.float(), dy.float(), cumlog.float()
    Bg, Cg = B.float(), C.float()
    Bf, Cf = (t.repeat_interleave(group, 0) for t in (Bg, Cg))

    def mm(a, b):
        return product(a, b, rounding)

    U, V, CB = ssm_prep_emulated(X, DY, Bg, Cg, cum, chunk, group, rounding)
    Hs = ssm_carry_emulated(U, cum, torch.zeros(BH, hd, ds), chunk, False)
    Gs = ssm_carry_emulated(V, cum, dh.float(), chunk, True)
    dx = torch.empty(BH, S, hd)
    dBp, dCp = torch.empty(BH, S, ds), torch.empty(BH, S, ds)
    dcum = torch.empty(BH, S)
    for c in range(-(-S // chunk)):
        t0, n = c * chunk, min(chunk, S - c * chunk)
        sl = slice(t0, t0 + n)
        x, d, b, cc, cm = X[:, sl], DY[:, sl], Bf[:, sl], Cf[:, sl], cum[:, sl]
        cb = CB[c].repeat_interleave(group, 0)
        H, G = Hs[:, c], Gs[:, c]
        tot = cm[:, -1]
        tiles = [(a, min(a + TILE, n)) for a in range(0, n, TILE)]
        dc, dcm = torch.zeros(BH, n, ds), torch.zeros(BH, n)
        ksum = torch.zeros(BH)
        for k, (j0, j1) in enumerate(tiles):
            adx = torch.zeros(BH, j1 - j0, hd)
            adb = torch.zeros(BH, j1 - j0, ds)
            cs = torch.zeros(BH, j1 - j0)
            for i0, i1 in reversed(tiles[k:]):
                ii = torch.arange(i0, i1)[:, None]
                jj = torch.arange(j0, j1)[None, :]
                diff = cm[:, i0:i1, None] - cm[:, None, j0:j1]
                L = torch.exp(diff.masked_fill(jj > ii, float("-inf")))
                P = cb[:, i0:i1, j0:j1] * L
                dP = mm(d[:, i0:i1], x[:, j0:j1].transpose(1, 2))
                M, R = dP * L, dP * P
                adx = adx + mm(P.transpose(1, 2), d[:, i0:i1])
                adb = adb + mm(M.transpose(1, 2), cc[:, i0:i1])
                dc[:, i0:i1] += mm(M, b[:, j0:j1])
                dcm[:, i0:i1] += R.sum(2)
                cs = cs + R.sum(1)
            e = torch.exp(tot[:, None] - cm[:, j0:j1])[..., None]
            adx = adx + e * mm(b[:, j0:j1], G.transpose(1, 2))
            Vj = e * mm(x[:, j0:j1], G)
            adb = adb + Vj
            K = (b[:, j0:j1] * Vj).sum(-1)
            W = torch.exp(cm[:, j0:j1])[..., None] * mm(d[:, j0:j1], H)
            dc[:, j0:j1] += W
            dcm[:, j0:j1] += -cs - K + (cc[:, j0:j1] * W).sum(-1)
            ksum = ksum + K.sum(-1)
            dx[:, t0 + j0:t0 + j1] = adx
            dBp[:, t0 + j0:t0 + j1] = adb
        dcm[:, n - 1] += ksum + torch.exp(tot) * (G * H).sum((1, 2))
        dCp[:, sl], dcum[:, sl] = dc, dcm
    dB = dBp.view(bh_bc, group, S, ds).sum(1).to(B.dtype)
    dC = dCp.view(bh_bc, group, S, ds).sum(1).to(C.dtype)
    return dx, dB, dC, dcum


def ssm_inputs(rng, bh, bh_bc, S, hd, ds, chunk, *, decay=0.2, dh=False,
               dtype=torch.float32):
    xbar = f32(rng, (bh, S, hd), 0.5)
    B, C = (f32(rng, (bh_bc, S, ds), 0.5).to(dtype) for _ in range(2))
    cum = chunk_cumsum(-f32(rng, (bh, S), decay).abs(), chunk)
    dy = f32(rng, (bh, S, hd))
    dhv = f32(rng, (bh, hd, ds)) if dh else torch.zeros(bh, hd, ds)
    return xbar, B, C, cum, dy, dhv


def ssm_ref_grads(xbar, B, C, cum, dy, chunk):
    """jax.vjp of ssm_scan_ref (B, C a row; S padded to whole chunks with
    zero inputs and zero log-decay, which the oracle needs and which
    changes no gradient of a real step), dB and dC summed over each
    group's heads."""
    BH, S, hd = xbar.shape
    bh_bc = B.shape[0]
    group = BH // bh_bc
    pad = -S % chunk

    def padded(t, value=None):
        if not pad:
            return t
        tail = (t[:, -1:].expand(t.shape[0], pad, *t.shape[2:])
                if value is None else torch.zeros(t.shape[0], pad,
                                                  *t.shape[2:]))
        return torch.cat([t, tail], 1)

    args = [jnp.asarray(padded(t, 0).numpy()) for t in (
        xbar, B.float().repeat_interleave(group, 0),
        C.float().repeat_interleave(group, 0))]
    args.append(jnp.asarray(padded(cum).numpy()))  # the last value held
    _, vjp = jax.vjp(lambda *a: ref.ssm_scan_ref(*a, chunk=chunk), *args)
    g = [torch.from_numpy(np.array(a))[:, :S]
         for a in vjp(jnp.asarray(padded(dy, 0).numpy()))]
    g[1] = g[1].view(bh_bc, group, S, -1).sum(1)
    g[2] = g[2].view(bh_bc, group, S, -1).sum(1)
    return g


def ssm_tols(group, chunk, hd, ds):
    """dxbar sums P dY over a chunk's steps and G B over ds; dB, dC sum
    over a chunk's steps and a group's heads; dcum the pairs of a chunk's
    row and column and the state terms (hd ds)."""
    return (dw_tol(chunk + ds), dw_tol(group * (chunk + hd)),
            dw_tol(group * (chunk + hd)), dw_tol(2 * chunk + hd * ds))


SSM_CASES = {  # bh, bh_bc, S, hd, ds, chunk, options
    "ragged S, 3 tiles a chunk": (2, 1, 300, 64, 64, 150, {}),
    "chunk 1": (2, 2, 40, 32, 16, 1, {}),
    "S 1": (2, 1, 1, 64, 64, 256, {}),
    "B/C groups, BH 4 over 2": (4, 2, 128, 64, 64, 64, {}),
    "nonzero dh": (2, 1, 200, 64, 32, 64, {"dh": True}),
    "hd 128, ds 128, ragged": (2, 1, 130, 128, 128, 100, {"dh": True}),
    "bf16 B/C, groups": (4, 2, 96, 64, 64, 32, {"dtype": torch.bfloat16}),
    "log-decay span above 88 in a chunk": (2, 1, 128, 64, 64, 128,
                                           {"decay": 4.0}),
}


@pytest.mark.parametrize("case", list(SSM_CASES))
def test_ssm_backward_design_matches_plain_and_jax(case):
    bh, bh_bc, S, hd, ds, chunk, opt = SSM_CASES[case]
    rng = np.random.default_rng(S * 1000 + hd + chunk)
    xbar, B, C, cum, dy, dh = ssm_inputs(rng, bh, bh_bc, S, hd, ds, chunk,
                                         **opt)
    got = ssm_bwd_emulated(xbar, B, C, cum, dy, dh, chunk=chunk)
    plain = ss.ssm_scan_bwd_plain(xbar, B, C, cum, dy, dh, chunk=chunk)
    tols = ssm_tols(bh // bh_bc, min(chunk, S), hd, ds)
    if B.dtype == torch.bfloat16:          # dB, dC rounded to bf16
        tols = (tols[0], 2e-2, 2e-2, tols[3])
    for g, p, tol, name in zip(got, plain, tols, ("dxbar", "dB", "dC",
                                                  "dcumlog")):
        assert g.dtype == p.dtype, name
        within(g, p, tol)
    if case.startswith("log-decay"):
        assert float(cum.min()) < -88.0    # the span inside one chunk
    if not opt.get("dh") and B.dtype == torch.float32:
        for g, r, tol in zip(got, ssm_ref_grads(xbar, B, C, cum, dy, chunk),
                             tols):
            within(g, r, tol)


def test_ssm_plain_forward_is_bitwise_unchanged_by_the_mask():
    """Masking the exponent's argument to -inf gives exp(-inf) = 0 where
    the mask after exp gave 0: y and h keep every bit."""
    rng = np.random.default_rng(5)
    for S, chunk in ((300, 128), (64, 16), (77, 77)):
        xbar, B, C, cum, _, _ = ssm_inputs(rng, 4, 2, S, 64, 32, chunk)
        y, h = ss.ssm_scan_plain(xbar, B, C, cum, chunk=chunk)
        y0, h0 = ssm_scan_mask_after(xbar, B, C, cum, chunk=chunk)
        assert torch.equal(y, y0) and torch.equal(h, h0)


def ssm_scan_mask_after(xbar, B, C, cumlog, *, chunk):
    """The plain version as it was, masking after the exponent
    (torch.where(tril, exp(diff), 0)) as JAX's ssm_block does."""
    BH, S, hd = xbar.shape
    ds = B.shape[-1]
    group = BH // B.shape[0]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xb = torch.nn.functional.pad(xbar.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B.float().repeat_interleave(group, 0),
                                 (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float().repeat_interleave(group, 0),
                                 (0, 0, 0, pad))
    cum = torch.cat([cumlog, cumlog[:, -1:].expand(BH, pad)], 1)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    h = torch.zeros(BH, hd, ds)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, Bc, Cc, cm = xb[:, sl], Bf[:, sl], Cf[:, sl], cum[:, sl]
        L = torch.where(tril, torch.exp(cm[:, :, None] - cm[:, None, :]), 0.0)
        y = ((Cc @ Bc.transpose(1, 2)) * L) @ xc
        y = y + torch.exp(cm)[..., None] * (Cc @ h.transpose(1, 2))
        tot = cm[:, -1:]
        h = h * torch.exp(tot)[..., None] + \
            (xc * torch.exp(tot - cm)[..., None]).transpose(1, 2) @ Bc
        ys.append(y)
    return torch.cat(ys, 1)[:, :S], h


def test_ssm_gradient_is_finite_where_the_mask_after_exp_gives_nan():
    """A chunk whose log-decay spans more than ~88: exp above the
    diagonal overflows, and autograd through a mask after exp is 0 * inf
    = NaN; the port's plain version and the kernel's design mask first
    and stay finite, and agree with jax.grad of the per-step oracle."""
    rng = np.random.default_rng(9)
    S, chunk = 128, 128
    xbar, B, C, cum, dy, dh = ssm_inputs(rng, 2, 1, S, 64, 64, chunk,
                                         decay=4.0)
    ins = [t.clone().requires_grad_(True) for t in (xbar, B, C, cum)]
    ssm_scan_mask_after(*ins, chunk=chunk)[0].backward(dy)
    assert bool(torch.isnan(ins[3].grad).any())
    plain = ss.ssm_scan_bwd_plain(xbar, B, C, cum, dy, dh, chunk=chunk)
    got = ssm_bwd_emulated(xbar, B, C, cum, dy, dh, chunk=chunk)
    for g in (*plain, *got):
        assert bool(g.isfinite().all())


def test_ssm_scan_function_runs_the_backward(monkeypatch):
    """SSMScan (the card's path) with the kernels replaced by the plain
    forward and the emulated backward: its gradients are autograd's
    through the plain version, dh of the dropped state is zeros, and the
    backward is counted as one launch."""
    calls = []

    def bwd(*a, chunk):
        calls.append(a[5].clone())
        return ssm_bwd_emulated(*a, chunk=chunk)

    monkeypatch.setattr(ss, "_forward",
                        lambda x, b, c, cm, chunk: ss.ssm_scan_plain(
                            x, b, c, cm, chunk=chunk))
    monkeypatch.setattr(ss, "ssm_scan_bwd_cuda", bwd)
    rng = np.random.default_rng(2)
    xbar, B, C, cum, dy, dh = ssm_inputs(rng, 4, 2, 100, 64, 32, 64)
    ins = [t.clone().requires_grad_(True) for t in (xbar, B, C, cum)]
    y, _ = ss.SSMScan.apply(*ins, 64)
    y.backward(dy)
    assert len(calls) == 1 and not bool(calls[0].any())
    want = ss.ssm_scan_bwd_plain(xbar, B, C, cum, dy, dh, chunk=64)
    for t, w, tol in zip(ins, want, ssm_tols(2, 64, 64, 32)):
        within(t.grad, w, tol)


def ssm_chunk_smem_bytes(esize, hp, ds):
    """ChunkLayout<Tin, HP, DS>::kBytes: the column tile's X (64 x HP + 8
    f32), B (64 x DS + 8 of B's dtype) and cum, the row tile's dY, C and
    cum; the pair's C B^T (64 x 72 f32); P and M (2 x 64 x 72 f32), or G
    or H (HP x DS + 8 f32) where larger; the sums (10 x 64, 8 warps)."""
    xs, bs, ts = hp + 8, ds + 8, TILE + 8
    pm = max(2 * TILE * ts * 4, hp * bs * 4)
    return 2 * (TILE * xs * 4 + TILE * bs * esize + TILE * 4) + \
        TILE * ts * 4 + pm + (10 * TILE + 8) * 4


def spreads_banks(stride):
    """A float2 a lane along a row (half a warp: lanes g, q at g stride +
    2q) and a word a lane down a column (a warp: q stride + g) each hit 32
    distinct banks."""
    along = {(g * stride + 2 * q + e) % 32 for g in range(4)
             for q in range(4) for e in range(2)}
    down = {(q * stride + g) % 32 for g in range(8) for q in range(4)}
    return len(along) == 32 and len(down) == 32


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("hp", [64, 128])
@pytest.mark.parametrize("ds", ss.STATE_DIMS)
def test_ssm_backward_layout_fits_and_spreads_banks(esize, hp, ds):
    """Every instance's shared memory fits a block of an H100; two blocks
    (16 warps) fit an SM at hd, ds <= 64 with bf16 B/C, zamba2's shape and
    the design's occupancy (kMinBlocks), and never at hd or ds 128; every
    staged f32 row's stride spreads the fragments' reads over the banks."""
    b = ssm_chunk_smem_bytes(esize, hp, ds)
    assert b <= H100_SMEM_PER_BLOCK
    two = 2 * (b + 1024) <= H100_SMEM_PER_SM
    if esize == 2 and hp == 64 and ds <= 64:
        assert two
    if hp == 128 or ds == 128:
        assert not two
    for stride in (hp + 8, ds + 8, TILE + 8):
        assert spreads_banks(stride), stride
    assert hp % 16 == 0 and ds % 16 == 0


def test_ssm_backward_needs_three_tf32_products():
    """One TF32 rounding of each product's operands puts the gradients
    past the tolerance that the kernel's 3xTF32 products meet with room
    (zamba2's chunk and widths, one B/C group of 8 heads)."""
    rng = np.random.default_rng(11)
    bh, S, hd, ds, chunk = 8, 256, 64, 64, 256
    xbar, B, C, cum, dy, dh = ssm_inputs(rng, bh, 1, S, hd, ds, chunk)
    plain = ss.ssm_scan_bwd_plain(xbar, B, C, cum, dy, dh, chunk=chunk)
    tols = ssm_tols(bh, chunk, hd, ds)

    def worst(rounding):
        got = ssm_bwd_emulated(xbar, B, C, cum, dy, dh, chunk=chunk,
                               rounding=rounding)
        return max(float(((g - p).abs() / (1 + p.abs())).max()) / tol
                   for g, p, tol in zip(got, plain, tols))

    one, three = worst("tf32"), worst("tf32x3")
    assert one > 1.0, one
    assert three < 0.1 and 30 * three < one, (three, one)


# -- rwkv6_scan --------------------------------------------------------------------

def rwkv_summaries_emulated(rf, kf, vf, wf, df, T):
    """rwkv6_bwd_sum_kernel: each chunk's decay g (BH, nc, hd), what it
    adds to the state, U = sum_t diag(b_t) k_t^T v_t (b_t the product of
    the w's after t in the chunk), and what it adds to the state's
    gradient across it, V = sum_t diag(a_t) r_t^T do_t (a_t the product
    of the w's before t): products of w only, never quotients."""
    BH, S, hd = rf.shape
    nc = -(-S // T)
    g = torch.empty(BH, nc, hd)
    U, V = torch.empty(BH, nc, hd, hd), torch.empty(BH, nc, hd, hd)
    for c in range(nc):
        t0, n = c * T, min(T, S - c * T)
        rt, kt = torch.empty(BH, n, hd), torch.empty(BH, n, hd)
        a = torch.ones(BH, hd)
        for t in range(n):
            rt[:, t] = a * rf[:, t0 + t]
            a = a * wf[:, t0 + t]
        g[:, c] = a
        b = torch.ones(BH, hd)
        for t in range(n - 1, -1, -1):
            kt[:, t] = b * kf[:, t0 + t]
            b = b * wf[:, t0 + t]
        U[:, c] = kt.transpose(1, 2) @ vf[:, t0:t0 + n]
        V[:, c] = rt.transpose(1, 2) @ df[:, t0:t0 + n]
    return g, U, V


def rwkv_carry_emulated(g, Z, x0, reverse):
    """rwkv6_bwd_carry_kernel: X (BH, hd, hd) carried over the chunks,
    written at each before X <- diag(g_c) X + Z_c: the state at each
    chunk's start (from U), its gradient at each chunk's end (from V and
    dS, in reverse)."""
    nc = Z.shape[1]
    out = torch.empty_like(Z)
    X = x0.clone()
    for c in (range(nc - 1, -1, -1) if reverse else range(nc)):
        out[:, c] = X
        X = g[:, c, :, None] * X + Z[:, c]
    return out


def rwkv_bwd_emulated(r, k, v, w, u, do, dstate, *, T=rs.BWD_CHUNK,
                      Ts=rs.BWD_SUB):
    """repro_rwkv6_scan_bwd's arithmetic: (dr, dk, dv, dw, du). The chunk
    summaries and the carry, then a chunk at a time: its state stepped
    forward from the checkpoint and kept every Ts steps, the sub-chunks
    walked in reverse (states recomputed from the kept one, dr on the way,
    dS carried back from the chunk's end checkpoint). The rows of the
    state are independent, so blocks of RB rows (rs.bwd_rows) run here as
    one; dv is summed over each block's rows, then over the blocks in
    order, du over the chunks and the heads of a u row."""
    BH, S, hd = r.shape
    nu = u.shape[0]
    nrb = hd // rs.bwd_rows(hd)
    rf, kf, vf, wf, df = (t.float() for t in (r, k, v, w, do))
    uf = u.float().repeat(BH // nu, 1)                    # (BH, hd)
    vdo = (vf * df).sum(-1)                               # (BH, S)
    nc = -(-S // T)
    g, U, V = rwkv_summaries_emulated(rf, kf, vf, wf, df, T)
    Ss = rwkv_carry_emulated(g, U, torch.zeros(BH, hd, hd), False)
    dSs = rwkv_carry_emulated(g, V, dstate.float(), True)
    dr, dk, dw, dv = (torch.empty(BH, S, hd) for _ in range(4))
    du_part = torch.empty(nc, BH, hd)
    for c in range(nc):
        t0, n = c * T, min(T, S - c * T)
        subs = [(a, min(a + Ts, n)) for a in range(0, n, Ts)]
        kept, st = [], Ss[:, c]
        for a, b in subs:                                 # forward
            kept.append(st)
            for t in range(t0 + a, t0 + b):
                st = wf[:, t, :, None] * st + kf[:, t, :, None] * vf[:, t, None]
        ds = dSs[:, c]
        for (a, b), st in reversed(list(zip(subs, kept))):
            steps = range(t0 + a, t0 + b)
            sts = []
            for t in steps:                               # recompute, dr
                sts.append(st)
                dr[:, t] = (st @ df[:, t, :, None])[..., 0] + \
                    uf * kf[:, t] * vdo[:, t, None]
                st = wf[:, t, :, None] * st + kf[:, t, :, None] * vf[:, t, None]
            for t, s_prev in zip(reversed(steps), reversed(sts)):
                dk[:, t] = (ds @ vf[:, t, :, None])[..., 0] + \
                    rf[:, t] * uf * vdo[:, t, None]
                dw[:, t] = (ds * s_prev).sum(-1)
                ruk = (rf[:, t] * uf * kf[:, t]).view(BH, nrb, -1)
                part = (ds * kf[:, t, :, None]).view(BH, nrb, -1, hd).sum(2) \
                    + ruk.sum(-1, keepdim=True) * df[:, t, None]
                dv[:, t] = part.sum(1)                    # the blocks in order
                ds = wf[:, t, :, None] * ds + rf[:, t, :, None] * df[:, t, None]
        du_part[c] = (rf[:, t0:t0 + n] * kf[:, t0:t0 + n]
                      * vdo[:, t0:t0 + n, None]).sum(1)
    du = du_part.view(nc * (BH // nu), nu, hd).sum(0)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(r.dtype),
            du)


def rwkv_inputs(rng, bh, nu, S, hd, *, w=None, dstate=False,
                dtype=torch.float32):
    r, k, v = (f32(rng, (bh, S, hd), 0.3) for _ in range(3))
    if w is None:
        w = torch.sigmoid(f32(rng, (bh, S, hd)))
    u = f32(rng, (nu, hd), 0.1)
    do = f32(rng, (bh, S, hd))
    ds = f32(rng, (bh, hd, hd)) if dstate else torch.zeros(bh, hd, hd)
    r, k, v, w, do = (t.to(dtype) for t in (r, k, v, w, do))
    return r, k, v, w, u, do, ds


def rwkv_ref_grads(r, k, v, w, u, do):
    """jax.vjp of rwkv6_scan_ref (u a row), du summed over the heads of
    each u row."""
    BH, S, hd = r.shape
    nu = u.shape[0]
    args = [jnp.asarray(t.float().numpy())
            for t in (r, k, v, w, u.repeat(BH // nu, 1))]
    _, vjp = jax.vjp(ref.rwkv6_scan_ref, *args)
    g = [torch.from_numpy(np.array(a))
         for a in vjp(jnp.asarray(do.float().numpy()))]
    g[4] = g[4].view(BH // nu, nu, hd).sum(0)
    return g


def rwkv_tols(S, hd, heads):
    """dr, dk, dv and dw sum hd terms a step (dv over the rows, the others
    over the columns), each carrying a state that sums up to S steps; du
    sums S steps of the heads of a u row."""
    t = dw_tol(hd + S)
    return t, t, t, t, dw_tol(S * heads)


RWKV_CASES = {  # bh, nu, S, hd, options
    "S 1": (2, 2, 1, 64, {}),
    "S 15": (4, 2, 15, 32, {}),
    "S 16": (2, 2, 16, 64, {}),
    "S 17, nonzero dS": (4, 2, 17, 64, {"dstate": True}),
    "S 33, hd 16": (4, 4, 33, 16, {}),
    "S 40, hd 128, one u row": (2, 1, 40, 128, {"dstate": True}),
    "S 150, bf16": (4, 2, 150, 64, {"dtype": torch.bfloat16}),
    "w at 0 and 1": (4, 2, 70, 64, {"w": "ends"}),
}


@pytest.mark.parametrize("case", list(RWKV_CASES))
def test_rwkv_backward_design_matches_plain_and_jax(case):
    bh, nu, S, hd, opt = RWKV_CASES[case]
    rng = np.random.default_rng(S * 1000 + hd)
    if opt.get("w") == "ends":
        w = torch.from_numpy(rng.choice(np.array([0.0, 1.0, 0.5, 0.9],
                                                 np.float32), (bh, S, hd)))
        w[0, :, :8] = 0.0                # channels that forget every step
        w[1, :, :8] = 1.0                # channels that never forget
        opt = {"w": w}
    args = rwkv_inputs(rng, bh, nu, S, hd, **opt)
    got = rwkv_bwd_emulated(*args)
    plain = rs.rwkv6_scan_bwd_plain(*args)
    tols = rwkv_tols(S, hd, bh // nu)
    if args[0].dtype == torch.bfloat16:  # dr, dk, dv, dw rounded to bf16
        tols = (2e-2,) * 4 + tols[4:]
    for g, p, tol in zip(got, plain, tols):
        assert g.dtype == p.dtype
        within(g, p, tol)
    if not opt.get("dstate") and args[0].dtype == torch.float32:
        for g, rg, tol in zip(got, rwkv_ref_grads(*args[:6]), tols):
            within(g, rg, tol)


def test_rwkv_scan_function_runs_the_backward(monkeypatch):
    """RWKV6Scan (the card's path) with the kernels replaced by the plain
    forward and the emulated backward: its gradients are autograd's
    through the plain version, and the state's gradient is zeros when
    the state is dropped."""
    calls = []

    def bwd(*a):
        calls.append(a[6].clone())
        return rwkv_bwd_emulated(*a)

    monkeypatch.setattr(rs, "_forward", rs.rwkv6_scan_plain)
    monkeypatch.setattr(rs, "rwkv6_scan_bwd_cuda", bwd)
    rng = np.random.default_rng(4)
    r, k, v, w, u, do, ds = rwkv_inputs(rng, 4, 2, 40, 64)
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    o, _ = rs.RWKV6Scan.apply(*ins)
    o.backward(do)
    assert len(calls) == 1 and not bool(calls[0].any())
    want = rs.rwkv6_scan_bwd_plain(r, k, v, w, u, do, ds)
    for t, wg, tol in zip(ins, want, rwkv_tols(40, 64, 2)):
        within(t.grad, wg, tol)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_rwkv_backward_layout_fits(hd):
    """ChunkLayout<HD>: a block owns RB rows, RB hd = 1024 entries (or the
    whole state at hd 16, 32), a row on TPR <= 32 lanes of one warp, CPT
    neighbouring columns a thread (16-byte reads where CPT is 4); its
    shared memory fits a block of an H100, two blocks (16 warps) an SM up
    to hd 64, rwkv6's (kMinBlocks); the summaries' fit a block. The
    checkpoints of a (head, chunk) of T steps hold the state every Ts
    steps, and T keeps their traffic under the operation bound at rwkv6's
    microbatch (BH 64, S 4096, hd 64)."""
    rb = rs.bwd_rows(hd)
    tpr = 256 // rb
    cpt = hd // tpr
    assert hd % rb == 0 and tpr <= 32 and 32 % tpr == 0 and tpr * cpt == hd
    assert rb * hd == min(hd * hd, 1024) and cpt in (1, 4)
    T, Ts = rs.BWD_CHUNK, rs.BWD_SUB
    assert T % Ts == 0
    for esize in (2, 4):             # bf16, f32 inputs
        # two stages (r, k, w rows and v, do in the inputs' dtype, v . do
        # f32), then u, the kept states, dv by warp, two arrays of row
        # partials (f32)
        stage = (3 * Ts * rb + 2 * Ts * hd) * esize + 4 * Ts
        assert stage % 16 == 0 and (3 * Ts * rb * esize) % 16 == 0
        floats = -(-rb // 4) * 4 + (T // Ts) * rb * hd + Ts * 8 * hd + \
            2 * Ts * rb * (tpr + 1)
        b = 2 * stage + 4 * floats
        assert b <= H100_SMEM_PER_BLOCK
        assert (2 * (b + 1024) <= H100_SMEM_PER_SM) == (hd <= 64)
    assert 5 * T * hd * 4 <= H100_SMEM_PER_BLOCK
    bh, S = 64, 4096
    ckpt = 2 * bh * (S // T) * 64 * 64 * 4          # S and dS (U, V before)
    assert 2 * 2 * ckpt / 3.35e12 < 0.195e-3       # written, read; twice


def test_rwkv_chunk_parallel_states_equal_the_recurrence():
    """The summaries and the carry give the state at each chunk's start
    and its gradient at each chunk's end; stepping the recurrence one
    step at a time gives the same within 2e-5, with w holding exact 0s
    (and 1s): every decay a product, nothing divided by w."""
    rng = np.random.default_rng(21)
    bh, S, hd, T = 4, 150, 32, rs.BWD_CHUNK
    r, k, v, w, u, do, dstate = rwkv_inputs(rng, bh, 2, S, hd, dstate=True)
    w = w.clone()
    w[:, ::7] = 0.0
    w[0, :, :4] = 0.0
    w[1, :, :4] = 1.0
    g, U, V = rwkv_summaries_emulated(r, k, v, w, do, T)
    Ss = rwkv_carry_emulated(g, U, torch.zeros(bh, hd, hd), False)
    dSs = rwkv_carry_emulated(g, V, dstate, True)
    st = torch.zeros(bh, hd, hd)
    for t in range(S):
        if t % T == 0:
            within(Ss[:, t // T], st, F32_TOL)
        st = w[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None]
    ds = dstate.clone()
    for t in range(S - 1, -1, -1):
        if t == S - 1 or (t + 1) % T == 0:
            within(dSs[:, t // T], ds, F32_TOL)
        ds = w[:, t, :, None] * ds + r[:, t, :, None] * do[:, t, None]


def test_ssm_chunk_parallel_states_equal_the_recurrence():
    """The prep pass's chunk terms (64-step tiles, 3xTF32) and the carry
    give the state at each chunk's start and its gradient at each chunk's
    end; stepping h_t = a_t h_{t-1} + x_t^T B_t, and its gradient s_t =
    a_{t+1} s_{t+1} + dy_t^T C_t back from dh, one step at a time gives
    the same within 2e-5 (G_c is what reaches the next chunk's start,
    a s there)."""
    rng = np.random.default_rng(22)
    bh, S, hd, ds, chunk = 2, 200, 32, 16, 64
    xbar, B, C, cum, dy, dh = ssm_inputs(rng, bh, 1, S, hd, ds, chunk,
                                         dh=True)
    U, V, _ = ssm_prep_emulated(xbar, dy, B, C, cum, chunk, bh, "tf32x3")
    Hs = ssm_carry_emulated(U, cum, torch.zeros(bh, hd, ds), chunk, False)
    Gs = ssm_carry_emulated(V, cum, dh, chunk, True)
    Bf, Cf = B.repeat(bh, 1, 1), C.repeat(bh, 1, 1)
    prev = torch.nn.functional.pad(cum, (1, 0))[:, :S]
    a = torch.exp(torch.where(torch.arange(S) % chunk == 0, cum, cum - prev))
    h = torch.zeros(bh, hd, ds)
    for t in range(S):
        if t % chunk == 0:
            within(Hs[:, t // chunk], h, F32_TOL)
        h = a[:, t, None, None] * h + xbar[:, t, :, None] * Bf[:, t, None]
    within(Gs[:, -1], dh, F32_TOL)
    sg = dh.clone()
    for t in range(S - 1, -1, -1):
        sg = sg + dy[:, t, :, None] * Cf[:, t, None]
        if t % chunk == 0 and t > 0:
            within(Gs[:, t // chunk - 1], a[:, t, None, None] * sg, F32_TOL)
        sg = a[:, t, None, None] * sg
