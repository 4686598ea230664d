"""The port's CUDA kernels against their plain PyTorch versions, and the
captured decode step against the eager one, on the card (marked
``cuda``; skipped where there is none). Needs no JAX:

    pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels with nvcc into build/repro_torch/.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.common import DTYPE_CODES, stream_of  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_cuda,
    flash_attention_lse_cuda, flash_attention_plain, flash_bwd_dkdv_cuda,
    flash_bwd_dq_cuda, flash_bwd_preprocess_cuda, flash_lse_plain)
from repro_torch.kernels.fused_rmsnorm import (  # noqa: E402
    fused_rmsnorm_bwd_cuda, fused_rmsnorm_bwd_plain, fused_rmsnorm_cuda,
    fused_rmsnorm_plain)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan_bwd_cuda, rwkv6_scan_bwd_plain, rwkv6_scan_cuda,
    rwkv6_scan_plain)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    chunk_cumsum, ssm_scan_bwd_cuda, ssm_scan_bwd_plain, ssm_scan_cuda,
    ssm_scan_plain)
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.transformer import (family_kind,  # noqa: E402
                                            zamba_groups)
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving.graphs import SlotDecoder  # noqa: E402

# test_kernels.py:23
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build with nvcc there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(card, dtype):
    """Kernel against plain version on the card, over ragged shapes, GQA
    and windows; f32 2e-5 / bf16 2e-2 as test_kernels.py."""
    g = torch.Generator(device=card).manual_seed(0)
    dt = TDT[dtype]

    def r(*shape):
        return torch.randn(shape, generator=g, device=card).to(dt)

    # fused_rmsnorm's register path (a row in 64 threads at d 2048, 128 at
    # d 4096, several rows a block) and its looping path (d not a multiple
    # of the 16-byte vector, d <= 1024 or past 4096, a row off 16-byte
    # alignment)
    for n, d in ((1, 4096), (77, 4096), (100, 128), (3, 72), (5, 8),
                 (600, 2048), (600, 4096), (4096, 4096), (7, 8192),
                 (33, 1000), (2, 12288), (9, 0)):
        w = torch.randn(d or 4096, generator=g, device=card) * 0.1
        # d 0: rows of 4096 one element off 16-byte alignment
        x = r(n, d) if d else r(n * 4096 + 1)[1:].view(n, 4096)
        torch.testing.assert_close(fused_rmsnorm_cuda(x, w),
                                   fused_rmsnorm_plain(x, w), **TOL[dtype])
    # the norm is a programmatic dependent launch: x and w written by the
    # kernel launched just before it are read only after its wait
    for n, d in ((1, 4096), (600, 2048), (3, 100)):
        x, w = r(n, d), torch.randn(d, generator=g, device=card)
        torch.testing.assert_close(
            fused_rmsnorm_cuda(x + 0.0, w * 0.1),
            fused_rmsnorm_plain(x, w * 0.1), **TOL[dtype])
    for bh, bh_kv, sq, sk, hd, causal, window in (
            (4, 4, 96, 96, 64, True, 0), (2, 2, 64, 192, 64, False, 0),
            (6, 2, 77, 77, 128, True, 0), (2, 2, 128, 128, 64, True, 16),
            (3, 3, 1, 1, 16, True, 0), (2, 2, 200, 200, 32, True, 64)):
        q, k, v = r(bh, sq, hd), r(bh_kv, sk, hd), r(bh_kv, sk, hd)
        torch.testing.assert_close(
            flash_attention_cuda(q, k, v, causal=causal, window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window),
            **TOL[dtype])
    for bh, bh_kv, s, hd, window in ((4, 4, 512, 64, 0), (6, 3, 96, 128, 0),
                                     (4, 4, 128, 16, 16)):
        q, k, v = r(bh, 1, hd), r(bh_kv, s, hd), r(bh_kv, s, hd)
        lengths = torch.tensor([s, max(s // 2, 1), 7, 1, 50, 3][:bh],
                               dtype=torch.int32, device=card)
        torch.testing.assert_close(
            decode_attention_cuda(q, k, v, lengths, window=window),
            decode_attention_plain(q, k, v, lengths, window=window),
            **TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scans_match_plain(card, dtype):
    """ssm_scan and rwkv6_scan against their plain versions on the card,
    output and final state, over ragged S, S at a chunk boundary, shared
    B/C groups and shared u rows, ssm chunks of 1 to 256 steps and ds 16 to
    128, up to the serving path's full widths
    (zamba2: BH 64, hd 64, ds 64, chunk 256; rwkv6: BH 32, hd 64). The
    low-precision dtype is that of B/C (ssm) or of r/k/v/w (rwkv); rwkv
    computes in f32, so "bfloat16" bounds only the rounding of its output.
    rwkv6_scan's kernel is the recurrence regrouped into chunks of 16
    steps (every decay a product of w's); its cases cover the chunk
    edges, hd 128 at S 600, one shared u row and w at 0, 1, 1e-30 and
    1 - 2^-24.
    ssm_scan's plain version is the chunked SSD form, its f32 kernel the
    recurrence and its bf16 kernel the chunked form on the tensor cores
    with every f32 operand split into two TF32 terms (3xTF32): each pair
    is held at 2e-4, as test_kernels.py:87 holds the Pallas chunked form
    against the sequential oracle."""
    g = torch.Generator(device=card).manual_seed(1)
    dt = TDT[dtype]

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=card) * scale

    for bh, bh_bc, s, hd, ds, chunk in (
            (4, 4, 96, 64, 16, 32), (4, 1, 100, 64, 64, 32),
            (64, 1, 768, 64, 64, 256), (64, 1, 600, 64, 64, 256),
            (2, 2, 1, 64, 32, 256), (3, 3, 33, 128, 128, 16),
            (2, 1, 256, 32, 64, 256),
            # the bf16 kernel's 64-step tiles, which restart at chunk starts
            (4, 4, 64, 64, 64, 16), (4, 1, 77, 64, 64, 77),
            (2, 2, 1, 64, 64, 1), (2, 2, 40, 64, 32, 1),
            (4, 2, 130, 64, 64, 256), (2, 1, 100, 64, 16, 256),
            (2, 1, 200, 64, 128, 128), (2, 1, 70, 128, 64, 64),
            (2, 1, 65, 96, 64, 256)):
        xbar = r(bh, s, hd, scale=0.5)
        B, C = r(bh_bc, s, ds, scale=0.5).to(dt), r(bh_bc, s, ds,
                                                    scale=0.5).to(dt)
        cum = chunk_cumsum(-r(bh, s, scale=0.2).abs(), chunk)
        y, h = ssm_scan_cuda(xbar, B, C, cum, chunk=chunk)
        y_ref, h_ref = ssm_scan_plain(xbar, B, C, cum, chunk=chunk)
        torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)
    # rwkv6: the chunked kernel's edges (chunks of 16 steps: S 15, 16, 17,
    # a last chunk of one step at S 513), hd 128 at S 600, one u row, and
    # w at the ends of its range (exact 0s and 1s, 1e-30, 1 - 2^-24)
    picks = torch.tensor([0.0, 1.0, 1e-30, 1.0 - 2.0 ** -24, 1e-3],
                         device=card)
    for bh, n_u, s, hd, extreme in (
            (4, 4, 96, 64, False), (4, 2, 100, 64, False),
            (32, 32, 600, 64, False), (2, 2, 1, 64, False),
            (3, 3, 33, 128, False), (2, 1, 40, 16, False),
            (2, 2, 32, 32, False), (2, 2, 15, 64, False),
            (2, 2, 16, 64, False), (2, 2, 17, 64, False),
            (4, 2, 513, 64, False), (8, 8, 600, 128, False),
            (4, 1, 77, 64, False), (4, 2, 70, 64, True),
            (2, 1, 513, 128, True)):
        rr, kk, vv = (r(bh, s, hd, scale=0.3).to(dt) for _ in range(3))
        if extreme:
            ww = picks[torch.randint(0, len(picks), (bh, s, hd),
                                     generator=g, device=card)].to(dt)
        else:
            ww = torch.sigmoid(r(bh, s, hd)).to(dt)
        u = r(n_u, hd, scale=0.1)
        o, st = rwkv6_scan_cuda(rr, kk, vv, ww, u)
        o_ref, st_ref = rwkv6_scan_plain(rr, kk, vv, ww, u)
        torch.testing.assert_close(o, o_ref, **TOL[dtype])
        torch.testing.assert_close(st, st_ref, **TOL["float32"])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_tilings_match_plain(card, dtype):
    """The attention kernels' tile and split edges against the plain
    versions (the edge cases chip_smoke.py checks). flash (bf16 on the
    tensor cores, f32 on the CUDA cores): Sq != Sk, GQA, a window across
    64-key tiles, ragged S at hd 16, q rows past a 64-row tile. decode
    (split-K, span 64 at cache 1024): lengths 1 and on / beside split
    edges, a window across split edges, GQA, and a 5000-slot cache whose
    splits take two chunks each."""
    g = torch.Generator(device=card).manual_seed(2)
    dt = TDT[dtype]

    def r(*shape):
        return torch.randn(shape, generator=g, device=card).to(dt)

    for bh, bh_kv, sq, sk, hd, causal, window in (
            (4, 4, 64, 192, 64, False, 0), (6, 2, 77, 77, 128, True, 0),
            (4, 4, 200, 200, 32, True, 64), (4, 4, 65, 65, 16, True, 0),
            (2, 2, 130, 70, 128, True, 0), (2, 1, 129, 129, 64, False, 40)):
        q, k, v = r(bh, sq, hd), r(bh_kv, sk, hd), r(bh_kv, sk, hd)
        torch.testing.assert_close(
            flash_attention_cuda(q, k, v, causal=causal, window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window),
            **TOL[dtype])
    edges = [1, 63, 64, 65, 127, 128, 129, 1024]
    for bh, bh_kv, s, hd, window, lens in (
            (8, 8, 1024, 128, 0, edges),
            (8, 8, 1024, 64, 100, [150, 1024, 64, 65, 300, 1, 200, 129]),
            (8, 2, 1024, 128, 0, [1024, 65, 64, 1, 700, 129, 2, 513]),
            (4, 4, 1024, 32, 64, [1, 64, 65, 1000]),
            (4, 1, 1024, 16, 0, [1, 64, 65, 999]),
            (4, 4, 5000, 64, 0, [5000, 129, 4097, 1]),
            (3, 3, 77, 128, 0, [77, 64, 65])):
        q, k, v = r(bh, 1, hd), r(bh_kv, s, hd), r(bh_kv, s, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device=card)
        torch.testing.assert_close(
            decode_attention_cuda(q, k, v, lengths, window=window),
            decode_attention_plain(q, k, v, lengths, window=window),
            **TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_hd240_and_softcap_match_plain(card, dtype):
    """gemma3-12b's head dim 240 in both attention kernels (the bf16 flash
    kernel streaming Q fragments from shared memory, the f32 one in
    16-key tiles; decode with a key a warp, two vectors a lane in f32),
    causal, windowed and GQA, decode over linear and ring lengths; and the
    logit softcap (c tanh(s / c) before the mask) at hd 64, 128 and 240,
    with caps that bind (the scores reach ~4 c)."""
    g = torch.Generator(device=card).manual_seed(4)
    dt = TDT[dtype]

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=card) * scale).to(dt)

    for bh, bh_kv, sq, sk, hd, causal, window, cap in (
            (4, 2, 130, 130, 240, True, 0, 0.0),
            (2, 1, 200, 200, 240, True, 64, 0.0),
            (2, 2, 64, 150, 240, False, 0, 0.0),
            (2, 2, 1, 1, 240, True, 0, 0.0),
            (4, 2, 130, 130, 240, True, 48, 2.0),
            (4, 4, 96, 96, 64, True, 0, 1.0),
            (6, 2, 77, 77, 128, True, 16, 3.0)):
        q = r(bh, sq, hd, scale=2.0)
        k, v = r(bh_kv, sk, hd, scale=2.0), r(bh_kv, sk, hd)
        kw = dict(causal=causal, window=window, softcap=cap)
        torch.testing.assert_close(flash_attention_cuda(q, k, v, **kw),
                                   flash_attention_plain(q, k, v, **kw),
                                   **TOL[dtype])
    for bh, bh_kv, s, hd, window, cap, lens in (
            (4, 2, 1024, 240, 0, 0.0, [1024, 600, 1, 65]),
            (4, 4, 1024, 240, 100, 0.0, [150, 1024, 64, 1]),
            (8, 4, 1024, 240, 0, 1.5, [1024, 1024, 700, 3, 1, 64, 65, 1000]),
            (4, 4, 512, 64, 0, 1.0, [512, 100, 7, 1]),
            (6, 3, 96, 128, 30, 2.0, [96, 50, 31, 1, 30, 77])):
        q = r(bh, 1, hd, scale=2.0)
        k, v = r(bh_kv, s, hd, scale=2.0), r(bh_kv, s, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device=card)
        kw = dict(window=window, softcap=cap)
        torch.testing.assert_close(
            decode_attention_cuda(q, k, v, lengths, **kw),
            decode_attention_plain(q, k, v, lengths, **kw), **TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_hd168_matches_plain(card, dtype):
    """gemma3-27b's head dim 168 in both attention kernels (bf16 flash: 11
    k-steps, the last on columns zero-filled in shared memory, stores
    stopping at column 167; f32 flash: 42 float4 chunks over 4 threads;
    decode: a key a warp, lanes 21-31 idle in bf16): its serving shapes
    (BH 32 over 16, S 600 causal, S 1500 with the window of 1024; decode
    at cache 1024, lengths 1024 and 600, and cache 2048 at 1904), ragged
    S across the 64-row tiles, Sq != Sk, a window across tile edges, a
    softcap, lengths on split edges. The flash output written into a
    NaN-poisoned buffer equals the plain version in every row, and the
    elements past it stay NaN. A head dim the kernels lack is refused."""
    g = torch.Generator(device=card).manual_seed(5)
    dt = TDT[dtype]

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=card) * scale).to(dt)

    for bh, bh_kv, sq, sk, causal, window, cap in (
            (32, 16, 600, 600, True, 0, 0.0),
            (4, 2, 1500, 1500, True, 1024, 0.0),
            (4, 2, 1, 1, True, 0, 0.0), (4, 2, 63, 63, True, 0, 0.0),
            (4, 2, 65, 65, True, 0, 0.0), (4, 2, 130, 130, True, 0, 0.0),
            (2, 2, 64, 150, False, 0, 0.0), (2, 2, 130, 70, True, 0, 0.0),
            (2, 1, 200, 200, True, 64, 0.0),
            (4, 2, 130, 130, True, 48, 2.0)):
        sc = 2.0 if cap else 1.0
        q = r(bh, sq, 168, scale=sc)
        k, v = r(bh_kv, sk, 168, scale=sc), r(bh_kv, sk, 168)
        kw = dict(causal=causal, window=window, softcap=cap)
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(flash_attention_cuda(q, k, v, **kw), want,
                                   **TOL[dtype])
        n = q.numel()
        buf = torch.full((n + 64,), float("nan"), dtype=dt, device=card)
        out = flash_attention_cuda(q, k, v, out=buf[:n].view(q.shape), **kw)
        assert out.data_ptr() == buf.data_ptr()
        torch.testing.assert_close(out, want, **TOL[dtype])
        assert bool(buf[n:].isnan().all())
    for bh, bh_kv, s, window, cap, lens in (
            (32, 16, 1024, 0, 0.0, [1024, 600] * 16),
            (32, 16, 2048, 0, 0.0, [1904] * 32),
            (8, 4, 1024, 0, 0.0, [1, 63, 64, 65, 127, 128, 129, 1024]),
            (4, 4, 1024, 100, 0.0, [150, 1024, 64, 1]),
            (8, 4, 1024, 0, 1.5, [1024, 1024, 700, 3, 1, 64, 65, 1000])):
        sc = 2.0 if cap else 1.0
        q = r(bh, 1, 168, scale=sc)
        k, v = r(bh_kv, s, 168, scale=sc), r(bh_kv, s, 168)
        lengths = torch.tensor(lens, dtype=torch.int32, device=card)
        kw = dict(window=window, softcap=cap)
        torch.testing.assert_close(
            decode_attention_cuda(q, k, v, lengths, **kw),
            decode_attention_plain(q, k, v, lengths, **kw), **TOL[dtype])
    for hd in (8, 96, 176):
        q, k = r(2, 16, hd), r(2, 16, hd)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_cuda(q, k, k)
        with pytest.raises(ValueError, match="head dim"):
            decode_attention_cuda(q[:, :1].contiguous(), k, k,
                                  torch.full((2,), 16, dtype=torch.int32,
                                             device=card))
    torch.cuda.synchronize()


# gemma3-27b at a narrow width that keeps its head dim 168
GRAPH_CONFIGS = {"gemma3-27b": dict(d_model=336, n_heads=2, n_kv_heads=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b", "rwkv6-1.6b",
                                  "granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b", "qwen2-vl-2b",
                                  "musicgen-large", "gemma3-12b",
                                  "gemma3-27b"])
def test_cuda_graph_replay_matches_eager_decode(card, arch):
    """Each slot's captured decode step against ``LM.decode_step`` on a
    twin cache (gemma3: its rings of 16 slots wrap during the steps;
    gemma3-27b at d 336 over 2 heads, so hd 168),
    in f32 at smoke size, before and right after the request
    is swapped from slot 0 into slot 1 (slot 0 then holds NaN): within
    1e-6 of the logits' scale (bitwise where the graph replays the eager
    kernels as they are). The launch counts grow by the launches of one
    capture a replay; warm-up, capture and the eager twin count nothing."""
    cfg = get_smoke(arch).with_(**GRAPH_CONFIGS.get(arch, {}))
    lm = LM.from_params(cfg, init_params(cfg, seed=0, device=card,
                                         dtype=torch.float32))
    g = torch.Generator(device=card).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (1, 21), generator=g, device=card)
    ops.reset_launch_counts()
    dec = SlotDecoder(lm, n_slots=2, max_len=64)
    assert set(ops.launch_counts().values()) == {0}
    per_step = dec.graphs[0].launches
    assert per_step == dec.graphs[1].launches
    assert per_step["fused_rmsnorm"] > 0
    with torch.inference_mode():
        with ops.uncounted():
            logits, twin = lm.prefill(prompt, 64)
        dec.prefill(0, prompt)
        before = ops.launch_counts()
        tok, slot = int(logits[0, -1].argmax()), 0
        for pos in range(21, 27):
            if pos == 24:
                saved = dec.save(0)
                for t in dec.caches[0].values():
                    t.fill_(float("nan"))
                dec.load(1, saved)
                slot = 1
            got = dec.step(slot, tok, pos).clone()
            with ops.uncounted():
                want, twin = lm.decode_step(
                    torch.tensor([tok], device=card), twin,
                    torch.tensor([pos], device=card))
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)
            tok = int(want[0, -1].argmax())
    after = ops.launch_counts()
    assert after == {n: before[n] + 6 * per_step[n] for n in after}
    torch.cuda.synchronize()


def mc_tasks(n_cores):
    """The smoke trace at 4 cores; past the warp's first lanes the
    600-a-minute trace's first 20 s in 5 s bursts, so that the cores
    queue, and whole bursts arrive and expire at one instant."""
    from repro_torch.traces import TraceSpec, generate_workload
    if n_cores == 4:
        return generate_workload(TraceSpec(
            minutes=1, invocations_per_min=60.0, n_functions=10,
            seed=0)).tasks
    big = generate_workload(TraceSpec(minutes=1, invocations_per_min=600.0,
                                      n_functions=40, seed=0)).tasks
    return [dataclasses.replace(t, arrival=5000.0 * (t.arrival // 5000.0))
            for t in big if t.arrival < 20000.0]


def assert_rows_bitwise(got, plain, rows):
    """Every output of the kernel equal to row rows[b] of the plain
    version's, floats bit for bit."""
    for k, want in plain.items():
        want = want[rows]
        g = got[k].cpu()
        if k == "n_iters":
            assert torch.equal(g, got["n_events"].cpu())
        elif want.dtype == torch.float64:
            assert torch.equal(g.view(torch.int64), want.view(torch.int64)), k
        else:
            assert torch.equal(g, want.to(g.dtype)), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_cores", [4, 31, 32, 33, 64, 65])
def test_cuda_mc_cell_matches_plain_bitwise(card, monkeypatch, n_cores):
    """mc_cell against run_grid_plain (on the CPU) on fifo / cfs / hybrid
    cells at 4 cores and on the warp's lane boundaries: every float bit
    for bit, every count and n_events exactly; run_grid on the card gives
    the same; 265 copies of the grid (3 cells a block, a last block of
    one) give each copy's plain row; a cell cut by its event cap comes
    back with ok False."""
    from repro_torch.kernels import mc_cell
    from repro_torch.mc import Cell, run_grid
    from repro_torch.mc.engine import _bucket, pack
    tasks = mc_tasks(n_cores)
    C = n_cores
    cells = [Cell("fifo", C, tasks), Cell("cfs", C, tasks),
             Cell("hybrid", C, tasks),
             Cell("hybrid", C, tasks, {"n_fifo": 1, "time_limit_ms": 40.0}),
             Cell("hybrid", C, tasks, {"n_fifo": 3, "time_limit_ms": 1e-3})]
    B = len(cells)
    args = tuple(map(torch.from_numpy, pack(cells, _bucket(len(tasks)))))
    plain = mc_cell.run_grid_plain(*args, n_cores=C)
    launches = mc_cell.launches
    got = mc_cell.mc_cell_cuda(*(a.to(card) for a in args), n_cores=C)
    torch.cuda.synchronize()
    assert mc_cell.launches == launches + 1
    assert_rows_bitwise(got, plain, torch.arange(B))
    out = run_grid(*(a.numpy() for a in args), n_cores=C)
    assert (out["completion"].view("int64")
            == plain["completion"].numpy().view("int64")).all()
    rows = torch.arange(2 * 132 + 1) % B
    many = mc_cell.mc_cell_cuda(*(a[rows].contiguous().to(card)
                                  for a in args), n_cores=C)
    assert_rows_bitwise(many, plain, rows)
    monkeypatch.setattr(mc_cell, "event_caps",
                        lambda service, n_tasks: torch.full_like(
                            n_tasks, 100, dtype=torch.int64))
    cut = mc_cell.mc_cell_cuda(*(a.to(card) for a in args), n_cores=C)
    assert cut["ok"].tolist() == [False] * B
    assert cut["n_events"].tolist() == [100] * B


# -- backward kernels ----------------------------------------------------------

# the log-sum-exp of the forward kernels: f32 as the kernel tolerance; the
# bf16 kernel sums exp2 of log2-scaled scores and takes m ln 2 + ln l, an
# f32 rounding away from the plain logsumexp of scores of its own inputs
LSE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=1e-4, atol=1e-4)}

# (bh, bh_kv, s, hd, window): ragged S around the 32-row tiles, GQA, a
# window across tiles, every head dim of HEAD_DIMS
BWD_SHAPES = ((4, 4, 96, 64, 0), (6, 2, 77, 128, 0), (2, 2, 130, 64, 16),
              (3, 3, 1, 16, 0), (2, 2, 63, 32, 0), (2, 2, 65, 168, 0),
              (4, 2, 130, 240, 0), (4, 2, 200, 128, 64), (3, 1, 33, 168, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_lse_matches_plain(card, dtype):
    """The forward kernels' log-sum-exp (BH, Sq) against the plain
    logsumexp of the masked scaled scores, the output unchanged."""
    g = torch.Generator(device=card).manual_seed(5)
    dt = TDT[dtype]
    for bh, bh_kv, s, hd, window in BWD_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=card).to(dt)
                   for shape in ((bh, s, hd), (bh_kv, s, hd), (bh_kv, s, hd)))
        out, lse = flash_attention_lse_cuda(q, k, v, window=window)
        torch.testing.assert_close(
            out, flash_attention_cuda(q, k, v, window=window), rtol=0, atol=0)
        torch.testing.assert_close(lse, flash_lse_plain(q, k, window=window),
                                   **LSE_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_matches_plain(card, dtype):
    """dq, dk, dv of ``ops.flash_attention`` on the card (the forward kernel
    with its log-sum-exp, then flash_bwd_preprocess, flash_bwd_dkdv and
    flash_bwd_dq) against autograd through the plain version, at the
    kernel tolerances (f32 2e-5, bf16 2e-2); a second backward gives the
    same bits, and each backward kernel launches once a call."""
    g = torch.Generator(device=card).manual_seed(6)
    dt = TDT[dtype]
    for bh, bh_kv, s, hd, window in BWD_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=g, device=card).to(dt)
                       for shape in ((bh, s, hd), (bh_kv, s, hd),
                                     (bh_kv, s, hd), (bh, s, hd)))
        want = flash_attention_bwd_plain(q, k, v, do, window=window)
        got = []
        for _ in range(2):
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            ops.reset_launch_counts()
            out = ops.flash_attention(qg, kg, vg, window=window)
            assert out.grad_fn is not None
            out.backward(do)
            counts = ops.launch_counts()
            assert [counts[n] for n in ("flash_attention",
                                        "flash_bwd_preprocess",
                                        "flash_bwd_dkdv",
                                        "flash_bwd_dq")] == [1, 1, 1, 1]
            got.append((qg.grad, kg.grad, vg.grad))
        for a, b, w in zip(got[0], got[1], want):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, w, **TOL[dtype])
    torch.cuda.synchronize()


# bf16 at gemma3's head dims on the tensor cores (hd 168 padded to 176,
# two warps a dkdv key slice, 32-key dq sub-steps): GQA G = 2, the local
# layers' window of 1024 binding at S 1100 (17 tiles of 64 and 12 rows),
# ragged S, non-causal
BWD_WIDE = ((4, 2, 1100, 240, 1024, True), (4, 2, 1100, 168, 1024, True),
            (4, 2, 130, 240, 0, True), (4, 2, 77, 168, 0, True),
            (2, 1, 200, 240, 0, False))


@pytest.mark.cuda
def test_cuda_flash_backward_wide_heads_on_tensor_cores(card):
    """bf16 dq, dk, dv at hd 168 and 240 against autograd through the plain
    version at 2e-2 (1 + |plain|), two runs bitwise equal."""
    g = torch.Generator(device=card).manual_seed(8)
    for bh, bh_kv, s, hd, window, causal in BWD_WIDE:
        q, k, v, do = (torch.randn(shape, generator=g, device=card)
                       .to(torch.bfloat16)
                       for shape in ((bh, s, hd), (bh_kv, s, hd),
                                     (bh_kv, s, hd), (bh, s, hd)))
        want = flash_attention_bwd_plain(q, k, v, do, causal=causal,
                                         window=window)
        got = []
        for _ in range(2):
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            ops.flash_attention(qg, kg, vg, causal=causal,
                                window=window).backward(do)
            got.append((qg.grad, kg.grad, vg.grad))
        for a, b, w in zip(got[0], got[1], want):
            assert torch.equal(a, b)
            diff = (a.float() - w.float()).abs()
            assert bool((diff <= 2e-2 * (1 + w.float().abs())).all()), \
                (hd, window, float(diff.max()))
    torch.cuda.synchronize()


def poisoned(shape, dtype):
    """(a view of shape at the head of a buffer of NaN with 64 elements
    past it, that tail)"""
    n = int(np.prod(shape))
    buf = torch.full((n + 64,), float("nan"), dtype=dtype, device="cuda")
    return buf[:n].view(shape), buf[n:]


@pytest.mark.cuda
def test_cuda_flash_backward_hd168_stores_no_pad_column(card):
    """At hd 168 the kernels compute 176 columns (the pad zero-filled) and
    store 168: dq, dk and dv written by the library into the head of
    NaN-poisoned buffers equal the wrappers' outputs row by row (a store
    past column 167 of a row lands in the next row's first columns) and
    leave the 64 elements past the last row NaN."""
    g = torch.Generator(device=card).manual_seed(9)
    bh, bh_kv, s, hd = 4, 2, 130, 168
    q, k, v, do = (torch.randn(shape, generator=g, device=card)
                   .to(torch.bfloat16)
                   for shape in ((bh, s, hd), (bh_kv, s, hd), (bh_kv, s, hd),
                                 (bh, s, hd)))
    out, lse = flash_attention_lse_cuda(q, k, v)
    delta = flash_bwd_preprocess_cuda(out, do)
    dk_w, dv_w = flash_bwd_dkdv_cuda(q, k, v, do, lse, delta)
    dq_w = flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    (dq, dq_tail), (dk, dk_tail), (dv, dv_tail) = (
        poisoned(t.shape, t.dtype) for t in (q, k, v))
    lib, code, st = build.library(), DTYPE_CODES[q.dtype], stream_of(q)
    build.check(lib.repro_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        bh_kv, s, s, hd, 1, 0, code, st), "flash_bwd_dkdv")
    build.check(lib.repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, bh_kv, s, s, hd,
        1, 0, code, st), "flash_bwd_dq")
    torch.cuda.synchronize()
    for got, want, tail in ((dq, dq_w, dq_tail), (dk, dk_w, dk_tail),
                            (dv, dv_w, dv_tail)):
        assert torch.equal(got, want)
        assert bool(tail.isnan().all())


def dw_tol(n):
    """dw sums n rows of f32 products (in either dtype): the rounding of
    such a sum grows as sqrt(n) in any order (the plain version's own dw
    is 4.5e-5 from the f64 sum at n 4096 on the CPU), so it is held at
    the f32 kernel tolerance times sqrt(n)."""
    t = 2e-5 * n ** 0.5
    return dict(rtol=t, atol=t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_backward_matches_plain(card, dtype):
    """dx, dw of the norm's backward kernel (a block a contiguous range of
    rows, dw partials summed in a fixed order) against autograd through
    the plain version, dx at the kernel tolerances and dw at ``dw_tol``,
    over ragged N and d (the register path's d 2048, 3840, 4096 and, in
    bf16, 5376; the looping path's), and two runs bitwise equal."""
    g = torch.Generator(device=card).manual_seed(7)
    dt = TDT[dtype]
    for n, d in ((1, 4096), (77, 4096), (600, 2048), (33, 1000), (5, 8),
                 (17, 5376), (4096, 4096), (16, 3840), (3, 100),
                 (2049, 3840), (1001, 5376)):
        x = torch.randn(n, d, generator=g, device=card).to(dt)
        dy = torch.randn(n, d, generator=g, device=card).to(dt)
        w = torch.randn(d, generator=g, device=card) * 0.1
        dx, dw = fused_rmsnorm_bwd_cuda(x, w, dy)
        dx2, dw2 = fused_rmsnorm_bwd_cuda(x, w, dy)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
        want_dx, want_dw = fused_rmsnorm_bwd_plain(x, w, dy)
        torch.testing.assert_close(dx, want_dx, **TOL[dtype])
        torch.testing.assert_close(dw, want_dw, **dw_tol(n))
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ops.fused_rmsnorm(xg, wg).backward(dy)
        assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_kernels_without_backward_raise_under_grad(card):
    """decode_attention and a capped flash_attention have no backward
    kernel: where a gradient is wanted they raise, never returning an
    output without a grad_fn; under no_grad they run. ssm_scan and
    rwkv6_scan have one: under grad their outputs carry a grad_fn."""
    q = torch.randn(2, 1, 64, device=card, requires_grad=True)
    k = torch.randn(2, 8, 64, device=card)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.decode_attention(q, k, k, lengths)
    qq = torch.randn(2, 8, 64, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="softcap"):
        ops.flash_attention(qq, k, k, softcap=2.0)
    xbar = torch.randn(2, 16, 16, device=card, requires_grad=True)
    B = torch.randn(2, 16, 16, device=card)
    y, h = ops.ssm_scan(xbar, B, B, torch.zeros(2, 16, device=card),
                        chunk=16)
    assert y.grad_fn is not None and h.grad_fn is not None
    r = torch.randn(2, 16, 16, device=card, requires_grad=True)
    w = torch.rand(2, 16, 16, device=card)
    o, st = ops.rwkv6_scan(r, w, w, w, torch.zeros(2, 16, device=card))
    assert o.grad_fn is not None and st.grad_fn is not None
    with torch.no_grad():
        ops.flash_attention(qq, k, k, softcap=2.0)
        ops.decode_attention(q, k, k, lengths)


def scan_tol(n):
    """f32 gradients of a scan over n steps: 2e-5 sqrt(n) (1 + |plain|),
    as the norm's dw over n rows (dw_tol)."""
    t = 2e-5 * max(n, 1) ** 0.5
    return dict(rtol=t, atol=t)


def check_backward(got, again, want, s):
    """Two calls bitwise equal, each gradient finite, of the plain
    version's dtype and within its tolerance: bf16 at 2e-2, f32 at
    scan_tol over the scan's s steps."""
    for a, b, w in zip(got, again, want, strict=True):
        assert torch.equal(a, b) and a.dtype == w.dtype
        assert bool(a.isfinite().all())
        tol = TOL["bfloat16"] if a.dtype == torch.bfloat16 else scan_tol(s)
        torch.testing.assert_close(a, w, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssm_scan_backward_matches_plain(card, dtype):
    """ssm_scan's backward kernel (dxbar, dB, dC, dcumlog) against autograd
    through the plain version, with a nonzero gradient of the final
    state, over ragged S, chunks of 1 to 256 steps (a chunk of 3 tiles of
    64), B/C groups, ds 16 to 128, hd up to 128 and a log-decay span above
    88 in a chunk (every gradient finite), B/C in ``dtype``; two calls
    bitwise equal, and the autograd Function's gradients the kernel's."""
    g = torch.Generator(device=card).manual_seed(5)
    dt = TDT[dtype]

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=card) * scale

    for bh, bh_bc, s, hd, ds, chunk, decay in (
            (4, 4, 96, 64, 16, 32, 0.2), (4, 2, 300, 64, 64, 150, 0.2),
            (128, 2, 600, 64, 64, 256, 0.2), (2, 2, 1, 64, 32, 256, 0.2),
            (3, 3, 33, 128, 128, 16, 0.2), (2, 2, 40, 32, 64, 1, 0.2),
            (2, 1, 65, 96, 64, 256, 0.2), (4, 1, 128, 64, 64, 128, 4.0)):
        xbar, dy = r(bh, s, hd, scale=0.5), r(bh, s, hd)
        B, C = (r(bh_bc, s, ds, scale=0.5).to(dt) for _ in range(2))
        cum = chunk_cumsum(-r(bh, s, scale=decay).abs(), chunk)
        dh = r(bh, hd, ds)
        got = ssm_scan_bwd_cuda(xbar, B, C, cum, dy, dh, chunk=chunk)
        again = ssm_scan_bwd_cuda(xbar, B, C, cum, dy, dh, chunk=chunk)
        want = ssm_scan_bwd_plain(xbar, B, C, cum, dy, dh, chunk=chunk)
        check_backward(got, again, want, s)
        ins = [t.clone().requires_grad_(True) for t in (xbar, B, C, cum)]
        y, h = ops.ssm_scan(*ins, chunk=chunk)
        torch.autograd.backward((y, h), (dy, dh))
        for t, a in zip(ins, got):
            assert torch.equal(t.grad, a)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_scan_backward_matches_plain(card, dtype):
    """rwkv6_scan's backward kernel (dr, dk, dv, dw, du) against autograd
    through the plain version, with a nonzero gradient of the final
    state, over the checkpoint edges (S 15, 16, 17, 513), hd 16 to 128,
    one u row and w at 0 and 1, r, k, v, w in ``dtype``; two calls
    bitwise equal, and the autograd Function's gradients the kernel's."""
    g = torch.Generator(device=card).manual_seed(6)
    dt = TDT[dtype]

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=card) * scale

    picks = torch.tensor([0.0, 1.0, 0.5, 0.9], device=card)
    for bh, n_u, s, hd, extreme in (
            (4, 2, 100, 64, False), (64, 32, 600, 64, False),
            (2, 2, 1, 64, False), (2, 2, 15, 32, False),
            (2, 2, 16, 64, False), (4, 2, 17, 64, False),
            (4, 2, 513, 64, False), (2, 1, 40, 16, False),
            (8, 8, 200, 128, False), (4, 1, 77, 64, False),
            (4, 2, 70, 64, True)):
        rr, kk, vv = (r(bh, s, hd, scale=0.3).to(dt) for _ in range(3))
        if extreme:
            ww = picks[torch.randint(0, len(picks), (bh, s, hd),
                                     generator=g, device=card)].to(dt)
        else:
            ww = torch.sigmoid(r(bh, s, hd)).to(dt)
        u, do, dstate = r(n_u, hd, scale=0.1), r(bh, s, hd).to(dt), \
            r(bh, hd, hd)
        args = (rr, kk, vv, ww, u, do, dstate)
        got = rwkv6_scan_bwd_cuda(*args)
        again = rwkv6_scan_bwd_cuda(*args)
        want = rwkv6_scan_bwd_plain(*args)
        check_backward(got, again, want, s)
        ins = [t.clone().requires_grad_(True) for t in (rr, kk, vv, ww, u)]
        o, st = ops.rwkv6_scan(*ins)
        torch.autograd.backward((o, st), (do, dstate))
        for t, a in zip(ins, got):
            assert torch.equal(t.grad, a)
    torch.cuda.synchronize()


# gemma3 at narrow widths that keep the real head dims
TRAIN_WIDE = {"gemma3-12b-hd240": ("gemma3-12b", dict(d_model=480, n_heads=2,
                                                      n_kv_heads=1)),
              "gemma3-27b-hd168": ("gemma3-27b", dict(d_model=336, n_heads=2,
                                                      n_kv_heads=1))}


def train_launches(cfg, n):
    """Kernel launches of n microbatches with per-layer remat: each norm,
    attention and scan inside a checkpoint runs forward twice (the
    forward, the recomputation) and backward once; the final norm once
    each way. zamba2: two norms and a scan a Mamba layer, and the shared
    block (two norms, attention) after every group; rwkv6: three norms and
    a scan a layer; the others two norms and attention a layer."""
    L, kind = cfg.n_layers, family_kind(cfg)
    scans = {}
    if kind == "zamba":
        shared = zamba_groups(cfg)[0]
        norms, attn, scans = 2 * L + 2 * shared, shared, {"ssm_scan": L}
    elif kind == "rwkv":
        norms, attn, scans = 3 * L, 0, {"rwkv6_scan": L}
    else:
        norms, attn = 2 * L, L
    out = {"fused_rmsnorm": (2 * norms + 1) * n,
           "fused_rmsnorm_bwd": (norms + 1) * n,
           "flash_attention": 2 * attn * n, "flash_bwd_preprocess": attn * n,
           "flash_bwd_dkdv": attn * n, "flash_bwd_dq": attn * n}
    for name, k in scans.items():
        out[name], out[f"{name}_bwd"] = 2 * k * n, k * n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-3b-a800m",
                                  "gemma3-12b", *TRAIN_WIDE, "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_cuda_smoke_trains_two_steps(card, arch):
    """Two train steps of the smoke config on the card (f32 masters, bf16
    compute, remat, 2 microbatches): the norms, attention and scans run
    the kernels forward and backward (granite: MoE and GQA; gemma3-12b:
    the window of its local layers; gemma3 at hd 240 and 168: the
    tensor-core backward at those head dims; zamba2 and rwkv6: the scans'
    backward kernels), every parameter gets a non-zero gradient, the
    losses are finite and the launch counts add up."""
    from repro_torch.configs import TrainConfig
    from repro_torch.training import (SyntheticLM, init_opt_state,
                                      make_train_step)
    name, widths = TRAIN_WIDE.get(arch, (arch, {}))
    cfg = get_smoke(name).with_(**widths)
    params = init_params(cfg, seed=0, device=card, dtype=torch.float32)
    lm = LM.from_params(cfg, params, dtype=torch.bfloat16)
    step_fn = make_train_step(lm, TrainConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=2, microbatches=2))
    opt = init_opt_state(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=96, batch=4, device=card)
    ops.reset_launch_counts()
    losses = []
    for _ in range(2):
        opt, m = step_fn(opt, data.next_batch())
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    want = train_launches(cfg, 2 * 2)               # steps x microbatches
    assert counts == {k: want.get(k, 0) for k in counts}
    assert all(np.isfinite(losses))
    for name, p in lm.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
