"""The arithmetic of the two attention kernels' designs, on the CPU.

``csrc/flash_attention.cu`` (bf16: FA2 on the tensor cores, P rounded
to bf16 for P V) and ``csrc/decode_attention.cu`` (split-K over the
cache, then a combine pass) run only on the card. Here each design is
emulated in plain PyTorch -- the same tiles, skipped tiles, masks, exp2
domain, bf16 rounding of P, split spans, empty splits and merge rule --
and held against the plain versions of the port and against the JAX
oracle (``repro.kernels.ref``) on inputs drawn with numpy from a seed;
with a logit softcap against the plain versions, whose cap is held
against the JAX model in test_torch_softcap.py. Both emulations cover hd
240 (a key a warp in decode) and hd 168 (flash: padded to 176 inside the
kernel, an 11th k-step and an 11th O group on zero columns; decode: a key
a warp, lanes 21-31 idle in bf16). The tensor-core kernel's shared-memory
layout and the f32 kernel's float4 chunks are checked for every head dim
of ``HEAD_DIMS``. The split planner of ``kernels/decode_attention.py`` is
tested too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.common import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_SPLITS, SPLIT_CHUNK, decode_attention_plain, plan_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)

NEG_INF = -1e30
BF16_TOL = 2e-2          # |kernel - plain| <= TOL * (1 + |plain|), chip_smoke
F32_TOL = 2e-5
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448  # bytes of dynamic shared memory a block
LOG2E = np.float32(1.4426950408889634)


def draw(rng, shape, dtype):
    """The same values for torch and JAX: f32 numpy, rounded once."""
    a = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def within(out, plain, tol):
    out, plain = out.float(), plain.float()
    assert bool(out.isfinite().all())
    diff = (out - plain).abs()
    assert bool((diff <= tol * (1 + plain.abs())).all()), float(diff.max())


# -- flash_attention, bf16 tensor-core design ----------------------------------

def tc_layout(hd, cap=False):
    """flash_tc_kernel's TcLayout: (columns in shared memory, padded to a
    multiple of 16; row stride in bf16; dynamic shared-memory bytes of Q
    and two stages of K and V; warps a 16-row slice: two at hd 240, and
    at hd 168 with the cap)."""
    pad = -(-hd // 16) * 16
    stride = pad + 8
    split = 2 if pad > 176 or (cap and pad > 128) else 1
    return pad, stride, 5 * 64 * stride * 2, split


def flash_tc_emulated(q, k, v, *, causal, window, softcap=0.0, bq=64,
                      bk=64, padded_out=False):
    """flash_tc_kernel's arithmetic: q tiles of ``bq`` rows, key tiles of
    ``bk`` from the first tile the window reaches to the last the causal
    mask allows; Q, K and V tiles in ``tc_layout(hd)[0]`` columns, those
    past hd zero (hd 168: 176, an 11th k-step of 16 columns); S = Q K^T
    of bf16 values in f32, taken to the exp2
    domain by scale * log2(e) (with a cap c: c log2(e) tanh(S scale / c));
    the mask applied only on tiles that need it
    (diagonal, window edge, past Sk); online softmax with f32 m and l;
    P rounded to bf16 for P V, O in all padded columns; out = acc /
    max(l, 1e-30) in bf16, its first hd columns stored (with
    ``padded_out``, every column, in f32)."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    group = BH // k.shape[0]
    hdp = tc_layout(hd)[0]

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, hdp - hd))

    q = padded(q)
    kf = padded(k).repeat_interleave(group, dim=0)
    vf = padded(v).repeat_interleave(group, dim=0)
    scale_log2 = float(LOG2E / np.sqrt(np.float32(hd), dtype=np.float32))
    out = torch.empty(BH, Sq, hdp)
    for q0 in range(0, Sq, bq):
        rows = torch.arange(q0, min(q0 + bq, Sq))
        q_last = int(rows[-1])
        k_end = min(Sk, q_last + 1) if causal else Sk
        k_begin = (max(0, q0 - window + 1) if window > 0 else 0) // bk * bk
        qt = q[:, rows].float()
        m = torch.full((BH, len(rows)), NEG_INF)
        l = torch.zeros(BH, len(rows))
        acc = torch.zeros(BH, len(rows), hdp)
        for kt in range(k_begin, k_end, bk):
            keys = torch.arange(kt, kt + bk)
            kk = torch.zeros(BH, bk, hdp)         # zero-filled past Sk
            vv = torch.zeros(BH, bk, hdp)
            n = min(bk, Sk - kt)
            kk[:, :n], vv[:, :n] = kf[:, kt:kt + n], vf[:, kt:kt + n]
            s = torch.matmul(qt, kk.transpose(1, 2))
            if softcap > 0:
                s = float(np.float32(softcap) * LOG2E) * torch.tanh(
                    s * float(np.float32(1 / np.sqrt(np.float32(hd)))
                              / np.float32(softcap)))
            else:
                s = s * scale_log2
            need_mask = (kt + bk > Sk or (causal and kt + bk - 1 > q0)
                         or (window > 0 and kt <= q0 + bq - 1 - window))
            if need_mask:
                ok = (keys < Sk)[None, :].expand(len(rows), bk)
                if causal:
                    ok = ok & (keys[None, :] <= rows[:, None])
                if window > 0:
                    ok = ok & (keys[None, :] > rows[:, None] - window)
                s = torch.where(ok, s, NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(torch.bfloat16).float(), vv)
            m = mx
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out if padded_out else out[..., :hd].to(torch.bfloat16)


@pytest.mark.parametrize("bh,bh_kv,sq,sk,hd,causal,window", [
    (2, 2, 600, 600, 128, True, 0),     # deepseek-7b prefill shape, BH cut
    (2, 2, 600, 600, 64, True, 0),      # zamba2 shared attention
    (4, 4, 64, 192, 64, False, 0),      # Sq != Sk
    (6, 2, 77, 77, 128, True, 0),       # GQA
    (4, 4, 200, 200, 32, True, 64),     # window across tile edges
    (4, 4, 65, 65, 16, True, 0),        # ragged S, hd 16
    (2, 2, 130, 70, 128, True, 0),      # Sq > Sk, causal on absolute index
    (4, 2, 130, 130, 240, True, 0),     # gemma3-12b's hd 240, GQA
    (2, 2, 200, 200, 240, True, 64),    # hd 240, window
    (4, 2, 130, 130, 168, True, 0),     # gemma3-27b's hd 168, GQA
    (2, 1, 200, 200, 168, True, 64),    # hd 168, window across tiles
    (2, 2, 64, 150, 168, False, 0),     # hd 168, Sq != Sk
    (4, 2, 63, 63, 168, True, 0),       # hd 168, ragged S
])
def test_flash_tc_design_matches_plain_and_ref(bh, bh_kv, sq, sk, hd, causal,
                                               window):
    rng = np.random.default_rng(sq * 31 + sk + hd)
    (tq, jq), (tk, jk), (tv, jv) = (draw(rng, (b, s, hd), torch.bfloat16)
                                    for b, s in ((bh, sq), (bh_kv, sk),
                                                 (bh_kv, sk)))
    emu = flash_tc_emulated(tq, tk, tv, causal=causal, window=window)
    plain = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    g = bh // bh_kv
    oracle = ref.flash_attention_ref(jq, jnp.repeat(jk, g, axis=0),
                                     jnp.repeat(jv, g, axis=0),
                                     causal=causal, window=window)
    within(emu, plain, BF16_TOL)
    within(emu, torch.from_numpy(np.array(oracle, np.float32)), BF16_TOL)


@pytest.mark.parametrize("hd,window,cap", [(64, 0, 1.0), (128, 48, 3.0),
                                           (240, 0, 2.0), (168, 48, 2.0)])
def test_flash_tc_design_with_softcap_matches_plain(hd, window, cap):
    """The cap in natural units before the exp2 domain, against the plain
    version's c tanh(s / c); scores reach ~4 c, so the cap binds."""
    rng = np.random.default_rng(hd + window)
    tq, tk, tv = (draw(rng, (b, 150, hd), torch.bfloat16)[0]
                  for b in (4, 2, 2))
    tq, tk = tq * 2, tk * 2
    emu = flash_tc_emulated(tq, tk, tv, causal=True, window=window,
                            softcap=cap)
    plain = flash_attention_plain(tq, tk, tv, window=window, softcap=cap)
    within(emu, plain, BF16_TOL)
    assert float((plain.float() - flash_attention_plain(
        tq, tk, tv, window=window).float()).abs().max()) > 5e-2


def test_flash_tc_hd168_pads_only_inside_the_kernel():
    """At hd 168 the tiles hold 176 columns: the 11th k-step multiplies
    zero columns of Q and K (its product is exactly 0, so the padded S
    equals the unpadded one), the 11th O group's last 8 columns are
    exactly 0 (V's zero columns), and the stored columns are the first
    168, equal to the unpadded emulation's."""
    rng = np.random.default_rng(168)
    tq, tk, tv = (draw(rng, (b, 130, 168), torch.bfloat16)[0]
                  for b in (4, 2, 2))
    full = flash_tc_emulated(tq, tk, tv, causal=True, window=0,
                             padded_out=True)
    assert full.shape == (4, 130, 176)
    assert bool((full[..., 168:] == 0).all())
    stored = flash_tc_emulated(tq, tk, tv, causal=True, window=0)
    assert torch.equal(stored, full[..., :168].to(torch.bfloat16))
    qp, kp = (torch.nn.functional.pad(t.float(), (0, 8)) for t in (tq, tk))
    last = torch.matmul(qp[..., 160:176], kp[..., 160:176].transpose(1, 2)
                        .repeat_interleave(2, 0))
    part = torch.matmul(tq.float()[..., 160:168], tk.float()[..., 160:168]
                        .transpose(1, 2).repeat_interleave(2, 0))
    assert torch.equal(last, part)
    within(stored, flash_attention_plain(tq, tk, tv), BF16_TOL)


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_tc_layout_is_conflict_free_and_fits(hd, cap):
    """Every head dim's smem rows are an odd count of 16-byte units (so
    the 8 rows an ldmatrix reads fall on distinct banks), the tiles fit
    a block's shared memory, and a warp's O stays at most 11 groups of
    16 columns (hd 240 splits them over two warps); hd 168: 176 columns,
    a stride of 184, 117,760 bytes, one warp a slice without the cap and
    two with it (6 and 5 groups)."""
    pad, stride, nbytes, split = tc_layout(hd, cap)
    assert pad % 16 == 0 and 0 <= pad - hd < 16 and hd % 8 == 0
    assert (stride * 2 // 16) % 2 == 1
    assert nbytes <= H100_SMEM_PER_BLOCK
    assert -(-pad // 16 // split) <= 11
    if hd == 168:
        assert (pad, stride, nbytes, split) == (176, 184, 117760, 1 + cap)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_f32_chunks_cover_each_row_once(hd):
    """flash_f32_kernel's 4 threads a row own float4 chunks sub + 4 c for
    c < ceil(hd / 16), those past the row not owned: every chunk of the
    row is owned exactly once (hd 168: 42 chunks, threads 0-1 own 11,
    2-3 own 10)."""
    n4, tpr = hd // 4, 4
    owned = [sub + tpr * c for sub in range(tpr)
             for c in range(-(-n4 // tpr)) if sub + tpr * c < n4]
    assert sorted(owned) == list(range(n4))
    if hd == 168:
        assert [sum(1 for c in range(11) if sub + 4 * c < 42)
                for sub in range(4)] == [11, 11, 10, 10]


def test_flash_tc_tiles_skip_only_dead_keys():
    """The tiles the kernel never loads hold no live key: at S 600 with a
    window of 100, every (row, key) pair the mask keeps lies in a visited
    tile, and the visited tiles cover fewer pairs than the dense product."""
    S, W, bq, bk = 600, 100, 64, 64
    visited = np.zeros((S, S), bool)
    for q0 in range(0, S, bq):
        q_last = min(q0 + bq, S) - 1
        k_begin = max(0, q0 - W + 1) // bk * bk
        for kt in range(k_begin, min(S, q_last + 1), bk):
            visited[q0:q0 + bq, kt:kt + bk] = True
    qi, ki = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    live = (ki <= qi) & (ki > qi - W)
    assert not (live & ~visited).any()
    assert visited.sum() < S * S // 3


# -- decode_attention, split-K design ------------------------------------------

def keys_per_warp_load(hd, element_size):
    """The split kernel's KeyLayout: a key's 16-byte vectors take hd / vec
    lanes where that divides the warp, else the whole warp (hd 168 and
    240)."""
    row = hd // (16 // element_size)
    return 32 // row if row <= 32 and 32 % row == 0 else 1


def decode_split_emulated(q, k, v, lengths, *, window, softcap=0.0):
    """decode_split_kernel + decode_combine_kernel: per split of
    ``plan_splits(S)``, the live keys [max(s0, begin), min(s1, len)) in
    64-key chunks, each key owned by lane group (warp, group) as in the
    kernel (16 keys a warp, ``keys_per_warp_load`` keys a warp load; at
    f32 hd 240 the warp's 16 keys in two batches of 8, each batch its own
    online step); the cap on the reduced dot of the pre-scaled q; each group
    keeps an online (m, l, acc), merged across the groups of a warp and
    then across the 4 warps by max / rescale / sum. An empty split writes
    m = -1e30, l = 0 and leaves acc unwritten (NaN here, as torch.empty
    may hold); the combine reads only the live splits."""
    BH, _, hd = q.shape
    S = k.shape[1]
    group = BH // k.shape[0]
    kpl = keys_per_warp_load(hd, q.element_size())
    # keys a batch of one online step: 16 a warp, 8 at f32 hd 240
    batch = 8 if (kpl == 1 and hd // (16 // q.element_size()) > 32) else 16
    span, splits = plan_splits(S)
    scale = float(1 / np.sqrt(np.float32(hd), dtype=np.float32))
    part = torch.full((BH, splits, hd + 2), float("nan"))
    for bh in range(BH):
        kvh = bh // group
        ln = min(int(lengths[bh]), S)
        begin = max(0, ln - window) if window > 0 else 0
        qf = q[bh, 0].float() * scale
        for sp in range(splits):
            s0, s1 = sp * span, min(sp * span + span, S)
            lo, hi = max(s0, begin), min(s1, ln)
            if lo >= hi:
                part[bh, sp, hd], part[bh, sp, hd + 1] = NEG_INF, 0.0
                continue
            m = torch.full((4, kpl), NEG_INF)
            l = torch.zeros(4, kpl)
            acc = torch.zeros(4, kpl, hd)
            c0 = lo - (lo - s0) % SPLIT_CHUNK
            for c, b0 in ((c, b0) for c in range(c0, hi, SPLIT_CHUNK)
                          for b0 in range(0, 16, batch)):
                # the batch's keys: b0 .. b0 + batch - 1 of each warp
                o = torch.tensor([w * 16 + b0 + i for w in range(4)
                                  for i in range(batch)])
                key = c + o
                live = (key >= lo) & (key < hi)
                kc = key.clamp(max=S - 1)
                dot = k[kvh, kc].float() @ qf
                if softcap > 0:
                    dot = softcap * torch.tanh(dot * (1 / softcap))
                s = torch.where(live, dot, NEG_INF)
                # key o of the chunk: warp o // 16, lane group (o % 16) % kpl
                flat = (o // 16) * kpl + (o % 16) % kpl
                mx = torch.full((4 * kpl,), NEG_INF).scatter_reduce(
                    0, flat, s, "amax")
                m_new = torch.maximum(m, mx.view(4, kpl))
                alpha = torch.exp(m - m_new)
                p = torch.where(live, torch.exp(s - m_new.view(-1)[flat]), 0.0)
                vv = torch.where(live[:, None], v[kvh, kc].float(), 0.0)
                l = l * alpha + torch.zeros(4 * kpl).index_add(
                    0, flat, p).view(4, kpl)
                acc = acc * alpha[..., None] + torch.zeros(
                    4 * kpl, hd).index_add(0, flat, p[:, None] * vv).view(
                        4, kpl, hd)
                m = m_new
            mw = m.amax(1, keepdim=True)                 # groups of a warp
            f = torch.exp(m - mw)
            lw, aw = (l * f).sum(1), (acc * f[..., None]).sum(1)
            mw = mw[:, 0]
            mt = mw.max()                                 # warps of a block
            fw = torch.exp(mw - mt)
            part[bh, sp, :hd] = (aw * fw[:, None]).sum(0)
            part[bh, sp, hd], part[bh, sp, hd + 1] = mt, (lw * fw).sum()
    out = torch.empty(BH, 1, hd, dtype=q.dtype)
    for bh in range(BH):
        ln = min(int(lengths[bh]), S)
        if ln <= 0:
            out[bh] = 0
            continue
        begin = max(0, ln - window) if window > 0 else 0
        pl = part[bh, begin // span:(ln - 1) // span + 1]
        mt = pl[:, hd].max()
        f = torch.exp(pl[:, hd] - mt)
        lt, at = (pl[:, hd + 1] * f).sum(), (pl[:, :hd] * f[:, None]).sum(0)
        out[bh, 0] = (at / lt.clamp_min(1e-30)).to(q.dtype)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,bh_kv,s,hd,window,lens", [
    (8, 8, 1024, 128, 0, [1, 63, 64, 65, 127, 128, 129, 1024]),  # edges
    (4, 4, 1024, 64, 0, [1, 1, 2, 77]),                # mostly empty splits
    (8, 8, 1024, 64, 100, [150, 1024, 64, 65, 300, 1, 200, 129]),  # window
    (8, 2, 1024, 128, 0, [1024, 65, 64, 1, 700, 129, 2, 513]),     # GQA
    (4, 1, 300, 16, 70, [1, 64, 65, 299]),             # MQA, window, hd 16
    (4, 4, 5000, 32, 0, [5000, 129, 4097, 1]),         # span 128
    (4, 2, 1024, 240, 0, [1024, 600, 1, 65]),          # hd 240, GQA
    (4, 4, 300, 240, 100, [150, 300, 64, 1]),          # hd 240, window
    (4, 2, 1024, 168, 0, [1024, 600, 1, 65]),          # hd 168, GQA
    (8, 4, 1024, 168, 0, [1, 63, 64, 65, 127, 128, 129, 1024]),  # edges
    (4, 4, 300, 168, 100, [150, 300, 64, 1]),          # hd 168, window
])
def test_decode_split_design_matches_plain_and_ref(dtype, bh, bh_kv, s, hd,
                                                   window, lens):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(s + hd + window)
    (tq, jq), (tk, jk), (tv, jv) = (draw(rng, (b, n, hd), dt) for b, n in
                                    ((bh, 1), (bh_kv, s), (bh_kv, s)))
    lengths = torch.tensor(lens, dtype=torch.int32)
    emu = decode_split_emulated(tq, tk, tv, lengths, window=window)
    plain = decode_attention_plain(tq, tk, tv, lengths, window=window)
    g = bh // bh_kv
    oracle = ref.decode_attention_ref(
        jq, jnp.repeat(jk, g, axis=0), jnp.repeat(jv, g, axis=0),
        jnp.asarray(lens, jnp.int32), window=window)
    within(emu, plain, tol)
    within(emu, torch.from_numpy(np.array(oracle, np.float32)), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,cap", [(64, 1.0), (240, 2.0), (168, 1.5)])
def test_decode_split_design_with_softcap_matches_plain(dtype, hd, cap):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(hd)
    tq, tk, tv = (draw(rng, (b, n, hd), dt)[0] for b, n in
                  ((4, 1), (2, 300), (2, 300)))
    tq, tk = tq * 2, tk * 2
    lengths = torch.tensor([300, 129, 16, 1], dtype=torch.int32)
    emu = decode_split_emulated(tq, tk, tv, lengths, window=0, softcap=cap)
    plain = decode_attention_plain(tq, tk, tv, lengths, softcap=cap)
    within(emu, plain, tol)


@pytest.mark.parametrize("hd,size,kpl", [(128, 2, 2), (128, 4, 1),
                                         (64, 2, 4), (16, 4, 8),
                                         (240, 2, 1), (240, 4, 1),
                                         (168, 2, 1), (168, 4, 1)])
def test_keys_per_warp_load(hd, size, kpl):
    assert keys_per_warp_load(hd, size) == kpl


@pytest.mark.parametrize("S", [1, 63, 64, 65, 600, 1024, 4096, 4097, 5000,
                               32768])
def test_plan_splits_covers_the_cache(S):
    span, splits = plan_splits(S)
    assert span % SPLIT_CHUNK == 0 and span > 0
    assert splits * span >= S > (splits - 1) * span
    assert 1 <= splits <= MAX_SPLITS


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b"])
def test_plan_splits_fills_the_card_at_serving_shapes(arch):
    """At batch 1 over the serving cache of 1024 slots (chip_smoke.py,
    launch/profile.py), the split pass has more blocks than the card has
    SMs; the kernel it replaces had one block per head (BH)."""
    bh = get_config(arch).n_heads
    _, splits = plan_splits(1024)
    assert splits * bh >= H100_SMS > bh
