"""The traffic generator: the same stream for a seed, the same sizes in
another order for another, the mixes' medians, the context, the rate."""
from __future__ import annotations

import json
import statistics
from pathlib import Path

import pytest

from cardbench.generators import azure_llm

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_stream(name):
    a, b = azure_llm.make(mix(name), 2**31 + 17), azure_llm.make(
        mix(name), 2**31 + 17)
    assert a == b


@pytest.mark.parametrize("name", MIXES)
def test_seeds_reorder_the_same_sizes(name):
    m = {k: v for k, v in mix(name).items() if k != "order_seed"}
    a, b = (azure_llm.make(m, s) for s in (3, 4))
    assert a.output != b.output
    assert sorted(a.output) == sorted(b.output)
    if a.due_s is not None:
        gaps = [sorted(x - y for x, y in zip(s.due_s, [0.0] + s.due_s[:-1]))
                for s in (a, b)]
        assert gaps[0] == pytest.approx(gaps[1])


@pytest.mark.parametrize("name", MIXES)
def test_an_order_seed_gives_every_seed_one_stream(name):
    m = dict(mix(name), order_seed=5)
    assert azure_llm.make(m, 3) == azure_llm.make(m, 2**31 + 4)
    assert azure_llm.make(m, 3) != azure_llm.make(dict(m, order_seed=6), 3)


@pytest.mark.parametrize("name", MIXES)
def test_medians_and_context(name):
    m = mix(name)
    s = azure_llm.make(m, 11)
    assert statistics.median(s.output) == pytest.approx(
        m["output"]["median"], rel=0.02)
    # the prompt is clipped to the context only past the median
    assert statistics.median(s.prompt) == pytest.approx(
        m["prompt"]["median"], rel=0.02)
    assert all(p + o - 1 <= m["context"] for p, o in zip(s.prompt, s.output))
    assert min(s.output) >= m["output"]["min"] >= 2


def test_open_loop_rate():
    m = mix("code_rate")
    s = azure_llm.make(m, 5)
    rate = m["arrivals"]["rate_per_s"]
    assert len(s.due_s) / s.due_s[-1] == pytest.approx(rate, rel=0.05)
    assert all(b > a for a, b in zip(s.due_s, s.due_s[1:]))


def test_low_discrepancy_order_spreads_every_run():
    m = dict(mix("code_rate"), order="low_discrepancy")
    s = azure_llm.make(m, 9)
    q = azure_llm.quantiles(m["n_requests"], m["output"]["median"],
                            m["output"]["sigma"], m["output"]["min"])
    med = statistics.median(q)
    for start in range(0, len(s.output) - 64, 64):
        run = s.output[start:start + 64]
        assert 24 <= sum(o > med for o in run) <= 40


def test_closed_loop_has_clients_not_due_times():
    s = azure_llm.make(mix("conv_closed"), 1)
    assert s.due_s is None and s.clients == mix("conv_closed")[
        "arrivals"]["clients"]
