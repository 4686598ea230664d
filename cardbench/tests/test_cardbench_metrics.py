"""The metric arithmetic on records made by hand: the bill clipped to the
window, the censored TTFT tail, the idle share's union, the traced calls'
reduction."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from cardbench import costs, trace
from cardbench.harness import ROOT, Record, Req, load_cell, load_module
from cardbench.readings import percentile, waited


def record(reqs, tokens, start=10.0, seconds=10.0, trace_=None):
    cell = load_cell("deepseek-7b.conv.closed", ROOT)
    rec = Record(cell, 1, seconds, dict(cell.config["port"],
                                        dtype="bfloat16"), 0.0,
                 start=start, end=start + seconds,
                 billed_gb=cell.config["billing"]["billed_gb"])
    for r in reqs:
        rec.reqs[r.rid] = r
    rec.tokens = tokens
    rec.trace = trace_
    return rec


def req(rid, due, pre=None, first=None, last=None, done=True, preempt=0):
    live = SimpleNamespace(completion_ms=1.0 if done else None,
                           preemptions=preempt)
    return Req(rid, 100, due, live, pre, first, last)


def metric(name):
    return load_module("metrics", name).read


def test_bill_is_clipped_to_the_window():
    # one request runs 5..15 (half in the window), one 12..30 unfinished
    # (runs to the window's end, 8 s), one 19..19.5 (0.5 s)
    reqs = [req(0, 4.0, 5.0, 5.1, 15.0), req(1, 11.0, 12.0, 12.2, 13.0,
                                             done=False),
            req(2, 18.0, 19.0, 19.1, 19.5)]
    rec = record(reqs, [12.0] * 50 + [25.0] * 7)
    gb_s = rec.billed_gb * 1.66667e-5
    usd = (5.0 + 8.0 + 0.5) * gb_s + 2 * 2e-7
    assert metric("usd_per_mtok")(rec) == pytest.approx(usd / 50 * 1e6)
    assert metric("tokens_per_s")(rec) == pytest.approx(5.0)


def test_ttft_tail_counts_requests_still_waiting():
    """The sweep's TTFT: a request with no token by the window's end
    counts with its wait so far, so a stall cannot drop out of the tail."""
    # 19 served after 0.1 s, one due at 11 and never served: it waits 9 s
    reqs = [req(i, 10.0 + 0.1 * i, first=10.1 + 0.1 * i) for i in range(19)]
    reqs.append(req(19, 11.0))
    rec = record(reqs, [])
    # linear interpolation at rank 0.95 * 19 = 18.05 of [0.1] * 19 + [9]
    assert percentile(waited(rec, "t_first"), 95) == pytest.approx(
        0.1 + 0.05 * 8.9)
    # a request due before the window is not the window's
    rec.reqs[20] = req(20, 9.0, first=15.0)
    assert len(waited(rec, "t_first")) == 20


def test_preemptions_per_started_request():
    reqs = [req(0, 10.0, pre=10.5, preempt=2), req(1, 10.0, pre=11.0),
            req(2, 19.0), req(3, 5.0, pre=6.0, preempt=7)]
    rec = record(reqs, [])
    assert metric("preempts_per_req")(rec) == pytest.approx(1.0)


def test_idle_share_is_one_minus_the_union():
    ev = [("engine.step", "CPU", 0.0, 1.0), ("engine.step", "CPU", 1.0, 2.0),
          ("k1", "CUDA", 0.1, 0.5), ("k2", "CUDA", 0.3, 0.6),
          ("k3", "CUDA", 1.5, 1.9), ("k4", "CUDA", 1.8, 2.5),
          ("decode", "CPU", 1.4, 1.95)]
    t = trace.reduce(ev)
    assert t["window_s"] == pytest.approx(2.0)
    assert t["busy_s"] == pytest.approx(0.5 + 0.5)
    # the metric reads the untraced segment's layer calls, clipped to it
    t["untraced"] = trace.untraced([(0.1, 0.5), (0.3, 0.6), (1.5, 1.9),
                                    (1.8, 2.5)], 2.0)
    assert t["untraced"]["busy_s"] == pytest.approx(0.5 + 0.5)
    rec = record([], [], trace_=t)
    assert metric("idle_share.tput")(rec) == pytest.approx(50.0)
    assert metric("idle_share.tput")(
        record([], [], trace_=dict(t, untraced=None))) is None
    # each gap goes to the innermost mark over its middle: 0..0.1 and
    # 0.6..1.5 (middle 1.05, before the decode opens) to the tick
    assert dict(t["breakdown"]["idle_gaps"]) == pytest.approx(
        {"engine.step": 1.0})
    # device time by operation, clipped to the segment
    assert dict(t["breakdown"]["device_ops"]) == pytest.approx(
        {"k1": 0.4, "k2": 0.3, "k3": 0.4, "k4": 0.2})


def test_traced_decodes_give_their_rooflines():
    m = load_cell("deepseek-7b.conv.closed", ROOT).config["port"]
    ev = [("engine.step", "CPU", 0.0, 1.0),
          ("decode", "CPU", 0.1, 0.4), ("decode", "CPU", 0.5, 0.9),
          ("nvjet_gemm", "CUDA", 0.1, 0.2),
          ("decode_split_kernel", "CUDA", 0.2, 0.25),
          ("decode_combine_kernel", "CUDA", 0.25, 0.27),
          ("nvjet_gemm", "CUDA", 0.5, 0.8),
          ("decode_split_kernel", "CUDA", 0.8, 0.83)]
    rec = record([], [], trace_=trace.reduce(ev))
    rec.m = dict(m, dtype="bfloat16")
    rec.decodes = [(0, 0, 0, 99, True), (0, 0, 1, 9, True),
                   (0, 0, 2, 5, False)]
    H, KV, hd, L = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["n_layers"]
    att = sum(L * costs.bound(*costs.decode(H, KV, hd, "bfloat16", H * n,
                                            KV * n))[0] / 1e3
              for n in (100, 10))
    assert load_module("metrics", "decode_attention_roofline").read(rec) \
        == pytest.approx(100 * att / 0.10)
    step = sum(max(b / costs.HBM_BW, f / costs.PEAK_FLOPS_BF16)
               for b, f in (costs.decode_step(rec.m, n) for n in (100, 10)))
    assert load_module("metrics", "decode_step_mfu").read(rec) \
        == pytest.approx(100 * step / (0.17 + 0.33))


def test_a_metric_with_nothing_to_read_is_left_out():
    rec = record([], [])
    for name in ("decode_step_mfu", "decode_attention_roofline",
                 "idle_share.tput"):
        assert metric(name)(rec) is None


def test_every_metric_has_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_module("metrics", entry["name"]).read)
