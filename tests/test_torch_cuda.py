"""The port's CUDA kernels against their plain PyTorch versions, and the
captured decode step against the eager one, on the card (marked
``cuda``; skipped where there is none). Needs no JAX:

    pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels with nvcc into build/repro_torch/.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.fused_rmsnorm import (  # noqa: E402
    fused_rmsnorm_cuda, fused_rmsnorm_plain)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan_cuda, rwkv6_scan_plain)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    chunk_cumsum, ssm_scan_cuda, ssm_scan_plain)
from repro_torch.models import LM  # noqa: E402
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
@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b", "rwkv6-1.6b",
                                  "granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_cuda_graph_replay_matches_eager_decode(card, arch):
    """Each slot's captured decode step against ``LM.decode_step`` on a
    twin cache, in f32 at smoke size, before and right after the request
    is swapped from slot 0 into slot 1 (slot 0 then holds NaN): within
    1e-6 of the logits' scale (bitwise where the graph replays the eager
    kernels as they are). The launch counts grow by the launches of one
    capture a replay; warm-up, capture and the eager twin count nothing."""
    cfg = get_smoke(arch)
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
