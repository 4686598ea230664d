"""The arithmetic of the scans' backward kernels, on the CPU.

``csrc/ssm_scan_bwd.cu`` and ``csrc/rwkv6_scan_bwd.cu`` run only on the
card. Here each is emulated in plain PyTorch, step for step as the kernel
orders its work, and held against autograd through the port's plain
versions and against ``jax.grad`` of the JAX oracles
(``repro.kernels.ref.ssm_scan_ref`` / ``rwkv6_scan_ref``, which take B
and u a row, so both are repeated per head and JAX's gradients summed
back over the heads that share them), on inputs drawn with numpy from a
seed.

* ``ssm_scan``: the state at each chunk's start (a forward pass over the
  chunks), the gradient of the state at each chunk's end carried back
  from dh (the reverse pass), then a (head, chunk) at a time in tiles of
  64 steps: a sweep over the column tiles j (against the row tiles i >=
  j) for dX, dB and the column sums of R = dP o P, a sweep over the row
  tiles i (against the tiles j <= i) for dC and the row sums, the state
  terms, and dcum; the exponent's argument masked (j <= i) before exp.
  dB and dC are summed over the heads of a group in order.
* ``rwkv6_scan``: a block a (head, RB rows of the state); pass 1 steps
  forward, writes a checkpoint of the state every 16 steps and forms dr;
  pass 2 walks the chunks in reverse, recomputes each chunk's states from
  its checkpoint and carries dS back through them; dv is summed over the
  row blocks and du over the heads of a u row.

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
TILE = 64                # ssm_bwd_chunk_kernel's steps a tile (kT)
GP = 32                  # rows of G or H a staged panel (kGP)
H100_SMEM_PER_BLOCK = 232448


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

def ssm_states_emulated(u, v, cum, x0, chunk, reverse):
    """ssm_bwd_state_kernel: X (BH, hd, ds) carried over the chunks (in
    reverse for the gradient), written at each chunk before its update
    X <- exp(tot) X + sum_t wt_t u_t^T v_t, with wt = exp(tot - cum)
    forward (u = xbar, v = B: the state at each chunk's start) and
    exp(cum) in reverse (u = dy, v = C: the state's gradient at each
    chunk's end). Returns (BH, nc, hd, ds)."""
    BH, S, _ = u.shape
    nc = -(-S // chunk)
    out = [None] * nc
    X = x0.clone()
    for c in (range(nc - 1, -1, -1) if reverse else range(nc)):
        t0, n = c * chunk, min(chunk, S - c * chunk)
        cm = cum[:, t0:t0 + n]
        tot = cm[:, -1]
        out[c] = X
        wt = torch.exp(cm) if reverse else torch.exp(tot[:, None] - cm)
        acc = (u[:, t0:t0 + n] * wt[..., None]).transpose(1, 2) @ \
            v[:, t0:t0 + n]
        X = torch.exp(tot)[:, None, None] * X + acc
    return torch.stack(out, 1)


def ssm_bwd_emulated(xbar, B, C, cumlog, dy, dh, *, chunk):
    """repro_ssm_scan_bwd's arithmetic: (dxbar, dB, dC, dcumlog)."""
    BH, S, hd = xbar.shape
    bh_bc, _, ds = B.shape
    group = BH // bh_bc
    X, DY, cum = xbar.float(), dy.float(), cumlog.float()
    Bf = B.float().repeat_interleave(group, 0)
    Cf = C.float().repeat_interleave(group, 0)
    Hs = ssm_states_emulated(X, Bf, cum, torch.zeros(BH, hd, ds), chunk,
                             False)
    Gs = ssm_states_emulated(DY, Cf, cum, dh.float(), chunk, True)
    dx = torch.empty(BH, S, hd)
    dBp, dCp = torch.empty(BH, S, ds), torch.empty(BH, S, ds)
    dcum = torch.empty(BH, S)
    for c in range(-(-S // chunk)):
        t0, n = c * chunk, min(chunk, S - c * chunk)
        sl = slice(t0, t0 + n)
        x, d, b, cc, cm = X[:, sl], DY[:, sl], Bf[:, sl], Cf[:, sl], cum[:, sl]
        H, G = Hs[:, c], Gs[:, c]
        tot = cm[:, -1]
        tiles = [(a, min(a + TILE, n)) for a in range(0, n, TILE)]

        def pair(ti, tj):
            (i0, i1), (j0, j1) = ti, tj
            ii = torch.arange(i0, i1)[:, None]
            jj = torch.arange(j0, j1)[None, :]
            diff = cm[:, i0:i1, None] - cm[:, None, j0:j1]
            L = torch.exp(diff.masked_fill(jj > ii, float("-inf")))
            P = (cc[:, i0:i1] @ b[:, j0:j1].transpose(1, 2)) * L
            dP = d[:, i0:i1] @ x[:, j0:j1].transpose(1, 2)
            return P, dP * L, dP * P

        ksum = torch.zeros(BH)
        for k, (j0, j1) in enumerate(tiles):             # sweep A
            adx = torch.zeros(BH, j1 - j0, hd)
            adb = torch.zeros(BH, j1 - j0, ds)
            cs = torch.zeros(BH, j1 - j0)
            for ti in tiles[k:]:
                P, M, R = pair(ti, (j0, j1))
                adx = adx + P.transpose(1, 2) @ d[:, ti[0]:ti[1]]
                adb = adb + M.transpose(1, 2) @ cc[:, ti[0]:ti[1]]
                cs = cs + R.sum(1)
            e = torch.exp(tot[:, None] - cm[:, j0:j1])[..., None]
            adx = adx + e * (b[:, j0:j1] @ G.transpose(1, 2))
            V = e * (x[:, j0:j1] @ G)
            adb = adb + V
            K = (b[:, j0:j1] * V).sum(-1)
            dx[:, t0 + j0:t0 + j1] = adx
            dBp[:, t0 + j0:t0 + j1] = adb
            dcum[:, t0 + j0:t0 + j1] = -cs - K
            ksum = ksum + K.sum(-1)
        dtot = ksum + torch.exp(tot) * (G * H).sum((1, 2))
        for k, (i0, i1) in enumerate(tiles):             # sweep B
            adc = torch.zeros(BH, i1 - i0, ds)
            rsum = torch.zeros(BH, i1 - i0)
            for tj in tiles[:k + 1]:
                _, M, R = pair((i0, i1), tj)
                adc = adc + M @ b[:, tj[0]:tj[1]]
                rsum = rsum + R.sum(2)
            W = torch.exp(cm[:, i0:i1])[..., None] * (d[:, i0:i1] @ H)
            adc = adc + W
            dCp[:, t0 + i0:t0 + i1] = adc
            dcum[:, t0 + i0:t0 + i1] += rsum + (cc[:, i0:i1] * W).sum(-1)
        dcum[:, t0 + n - 1] += dtot
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


def ssm_chunk_smem_bytes(hp, ds):
    """ChunkLayout<HP, DS>::kBytes: X, dY (64 x HP + 1), B, C (64 x DS +
    1), P, M, R (64 x 65), a panel of G / H (32 x DS + 1), two tiles' cum,
    K, the sums."""
    xs, bs, ps = hp + 1, ds + 1, TILE + 1
    return 4 * (2 * TILE * xs + 2 * TILE * bs + 3 * TILE * ps + GP * bs
                + 3 * TILE + 1 + 256 // 32)


@pytest.mark.parametrize("hp", [64, 128])
@pytest.mark.parametrize("ds", ss.STATE_DIMS)
def test_ssm_backward_layout_fits_and_spreads_banks(hp, ds):
    """Every instance's shared memory fits a block of an H100, and every
    staged row has an odd stride (a column read by 16 threads hits 16
    banks)."""
    assert ssm_chunk_smem_bytes(hp, ds) <= H100_SMEM_PER_BLOCK
    assert (hp + 1) % 2 == 1 and (ds + 1) % 2 == 1 and (TILE + 1) % 2 == 1
    assert hp // 16 >= 1 and ds % 16 == 0 and hp % GP == 0


# -- rwkv6_scan --------------------------------------------------------------------

def rwkv_bwd_emulated(r, k, v, w, u, do, dstate, *, T=rs.BWD_CHUNK):
    """repro_rwkv6_scan_bwd's arithmetic: (dr, dk, dv, dw, du). Blocks of
    RB rows (rs.bwd_rows) step their rows independently; dv is summed
    over the row blocks, du over the heads of a u row."""
    BH, S, hd = r.shape
    nu = u.shape[0]
    RB = rs.bwd_rows(hd)
    nrb = hd // RB
    rf, kf, vf, wf, df = (t.float() for t in (r, k, v, w, do))
    uf = u.float().repeat(BH // nu, 1)                    # (BH, hd)
    vdo = (vf * df).sum(-1)                               # (BH, S)
    nc = -(-S // T)
    dr, dk, dw = (torch.empty(BH, S, hd) for _ in range(3))
    dv_part = torch.empty(BH, nrb, S, hd)
    du_part = torch.empty(BH, hd)
    for b in range(nrb):
        rows = slice(b * RB, (b + 1) * RB)
        st = torch.zeros(BH, RB, hd)
        ckpt = []
        for c in range(nc):                               # pass 1
            ckpt.append(st)
            for t in range(c * T, min(S, (c + 1) * T)):
                dr[:, t, rows] = (st @ df[:, t, :, None])[..., 0] + \
                    uf[:, rows] * kf[:, t, rows] * vdo[:, t, None]
                st = wf[:, t, rows, None] * st + \
                    kf[:, t, rows, None] * vf[:, t, None, :]
        du_part[:, rows] = (rf[:, :, rows] * kf[:, :, rows]
                            * vdo[..., None]).sum(1)
        ds = dstate[:, rows].float()
        for c in range(nc - 1, -1, -1):                   # pass 2
            steps = range(c * T, min(S, (c + 1) * T))
            sts, cur = [], ckpt[c]                        # the recompute
            for t in steps:
                sts.append(cur)
                cur = wf[:, t, rows, None] * cur + \
                    kf[:, t, rows, None] * vf[:, t, None, :]
            for t, s_prev in zip(reversed(steps), reversed(sts)):
                dk[:, t, rows] = (ds @ vf[:, t, :, None])[..., 0] + \
                    rf[:, t, rows] * uf[:, rows] * vdo[:, t, None]
                dw[:, t, rows] = (ds * s_prev).sum(-1)
                ruk = rf[:, t, rows] * uf[:, rows] * kf[:, t, rows]
                dv_part[:, b, t] = (ds * kf[:, t, rows, None]).sum(1) + \
                    ruk.sum(-1, keepdim=True) * df[:, t]
                ds = wf[:, t, rows, None] * ds + \
                    rf[:, t, rows, None] * df[:, t, None, :]
    dv = dv_part.sum(1)
    du = du_part.view(BH // nu, nu, hd).sum(0)
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
    """BwdLayout<HD>: a block owns RB rows, RB hd = 1024 entries (or the
    whole state at hd 16, 32), a row on TPR <= 32 lanes of one warp, CPT
    columns a thread, and the shared memory fits a block of an H100."""
    rb = rs.bwd_rows(hd)
    tpr = 256 // rb
    cpt = hd // tpr
    assert hd % rb == 0 and tpr <= 32 and 32 % tpr == 0 and tpr * cpt == hd
    assert rb * hd == min(hd * hd, 1024)
    T = rs.BWD_CHUNK
    floats = 3 * T * rb + 2 * T * hd + T + rb + T * 8 * hd + \
        2 * T * rb * (tpr + 1)
    assert 4 * floats <= H100_SMEM_PER_BLOCK
