"""The port's own copies of the simulator pieces the Monte-Carlo engine
needs, against the JAX package's originals: the trace synthesis and load
scaling (bit for bit over several specs), the regime helpers and ``Task``
(on edge values), the paper config, and the cost and ``SimResult``
roll-ups (on the scalar engine's tasks)."""
import math
from dataclasses import asdict, fields

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro import FleetSpec, PolicySpec, Scenario, WorkloadSpec  # noqa: E402
from repro.configs import paper as jax_paper  # noqa: E402
from repro.core import events as jax_events  # noqa: E402
from repro.core import cost as jax_cost  # noqa: E402
from repro.traces import TraceSpec as JaxTraceSpec  # noqa: E402
from repro.traces import azure as jax_azure  # noqa: E402
from repro.traces import generate_workload as jax_generate  # noqa: E402
from repro.traces import scale_load as jax_scale_load  # noqa: E402
from repro_torch.configs import paper  # noqa: E402
from repro_torch.core import cost, events  # noqa: E402
from repro_torch.core.metrics import SimResult  # noqa: E402
from repro_torch.kernels.mc_cell import _tmax, _tmin  # noqa: E402
from repro_torch.traces import (TraceSpec, azure, generate_workload,  # noqa: E402
                                scale_load)

SPECS = [
    dict(minutes=1, invocations_per_min=60.0, n_functions=10, seed=0),
    dict(minutes=1, invocations_per_min=600.0, n_functions=40, seed=3),
    dict(minutes=2, invocations_per_min=300.0, n_functions=25, seed=7,
         burst_sigma=0.9, duration_jitter=0.2, zipf_s=1.4),
    dict(minutes=3, invocations_per_min=120.0, n_functions=5, seed=11),
    dict(),                                   # the paper's trace, seed 0
]

TASK_FIELDS = [f.name for f in fields(events.Task)]


def _rows(tasks):
    return [tuple(repr(getattr(t, f)) for f in TASK_FIELDS) for t in tasks]


def test_task_fields_match():
    assert TASK_FIELDS == [f.name for f in fields(jax_events.Task)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: str(s.get("seed", 0))
                         + "-" + str(s.get("minutes", 2)))
def test_generate_workload_is_bit_identical(spec):
    mine = generate_workload(TraceSpec(**spec))
    ref = jax_generate(JaxTraceSpec(**spec))
    assert repr(mine.scale) == repr(ref.scale)
    assert _rows(mine.tasks) == _rows(ref.tasks)
    assert np.array_equal(mine.iats, ref.iats)
    assert repr(mine.p90_service()) == repr(ref.p90_service())


@pytest.mark.parametrize("spec", SPECS[:3], ids=["smoke", "600", "bursty"])
def test_synth_functions_match(spec):
    mine = azure.synth_functions(TraceSpec(**spec))
    ref = jax_azure.synth_functions(JaxTraceSpec(**spec))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a.func_id, a.bucket, a.mem_mb, repr(a.rate)) == \
            (b.func_id, b.bucket, b.mem_mb, repr(b.rate))
        assert np.array_equal(a.counts, b.counts)
    assert azure.BUCKET_MS == jax_azure.BUCKET_MS
    assert azure.FIB_N == jax_azure.FIB_N
    assert asdict(TraceSpec()) == asdict(JaxTraceSpec())


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.5, 3.0])
def test_scale_load_is_bit_identical(factor):
    spec = SPECS[1]
    mine = scale_load(generate_workload(TraceSpec(**spec)).tasks, factor)
    ref = jax_scale_load(jax_generate(JaxTraceSpec(**spec)).tasks, factor)
    assert _rows(mine) == _rows(ref)


def test_scale_load_refuses_nonpositive():
    with pytest.raises(ValueError):
        scale_load([], 0.0)


# -- the regime helpers, on edge values -----------------------------------------

EDGE = [0.0, events._EPS, 2 * events._EPS, 0.5 * events._EPS, 0.01, 3.0,
        24.0, 1633.0, 1e5, math.inf]


def _cases(name):
    if name == "chunk_run_ms":
        return [((r,), {}) for r in EDGE] + \
            [((r, lim), {}) for r in EDGE for lim in EDGE]
    if name == "chunk_end_ms":
        return [((t, c, r), {}) for t in (0.0, 1.5, 1e5)
                for c in (0.0, 0.06) for r in EDGE[:-1]]
    if name == "cfs_slice_ms":
        return [((nr, 24.0, 3.0), {}) for nr in (0, 1, 2, 3, 7, 8, 9, 50)]
    if name == "fifo_budget_ms":
        return [((lim, cpu), {}) for lim in EDGE for cpu in (0.0, 0.005,
                                                             1633.0)]
    return [((r, run), {}) for r in EDGE[:-1] for run in EDGE[:-1]]


HELPERS = ["chunk_run_ms", "chunk_end_ms", "cfs_slice_ms", "fifo_budget_ms",
           "chunk_completes"]


@pytest.mark.parametrize("name", HELPERS)
def test_regime_helpers_match_on_edge_values(name):
    """The copy equals the original in Python, and bound to torch's
    minimum / maximum in f64 (the plain version's binding) it gives the
    same bits."""
    mine, ref = getattr(events, name), getattr(jax_events, name)
    kw = {"chunk_run_ms": dict(_min=_tmin, _max=_tmax),
          "cfs_slice_ms": dict(_max=_tmax),
          "fifo_budget_ms": dict(_max=_tmax)}.get(name, {})
    for args, _ in _cases(name):
        want = ref(*args)
        assert repr(mine(*args)) == repr(want)
        targs = [torch.tensor(a, dtype=torch.int64 if isinstance(a, int)
                              else torch.float64) for a in args]
        got = mine(*targs, **kw)
        assert repr(got.item()) == repr(want), (name, args)
    assert events._EPS == jax_events._EPS


def test_task_metrics_match():
    for comp, fr in ((None, None), (None, 5.0), (12.5, 5.0), (7.0, 7.0)):
        a = events.Task(tid=3, arrival=1.25, service=4.0)
        b = jax_events.Task(tid=3, arrival=1.25, service=4.0)
        for t in (a, b):
            t.completion, t.first_run = comp, fr
        for prop in ("finished", "execution", "response", "turnaround"):
            assert repr(getattr(a, prop)) == repr(getattr(b, prop))
    assert events.Task(tid=0, arrival=0.0, service=9.0).remaining == 9.0


def test_paper_config_matches():
    assert asdict(paper.CONFIG) == asdict(jax_paper.CONFIG)


# -- cost and SimResult roll-ups on the scalar engine's tasks -------------------

@pytest.mark.parametrize("policy", ["fifo", "cfs", "hybrid"])
def test_simresult_summary_matches(policy):
    spec = SPECS[0]
    res = repro.run(Scenario(
        workload=WorkloadSpec(kind="azure", trace=JaxTraceSpec(**spec)),
        fleet=FleetSpec(cores_per_node=4), policy=PolicySpec(name=policy)))
    raw = res.raw
    tasks = []
    for t in reversed(raw.tasks):             # order must not matter
        c = events.Task(tid=t.tid, arrival=t.arrival, service=t.service,
                        mem_mb=t.mem_mb, func_id=t.func_id, bucket=t.bucket)
        for f in ("completion", "first_run", "cpu_time", "preemptions",
                  "ctx_switches", "migrations"):
            setattr(c, f, getattr(t, f))
        tasks.append(c)
    mine = SimResult(policy=policy, tasks=tasks, total_ctx=raw.total_ctx)
    assert mine.summary() == raw.summary()
    assert mine.cost_ladder() == raw.cost_ladder()
    assert mine.p99() == raw.p99()
    assert mine.cost_usd(fixed_mem_mb=512) == raw.cost_usd(fixed_mem_mb=512)


def test_cost_helpers_match():
    ex = [0.0, 1.5, 80.0, 1633.0, 123456.789]
    mem = [128, 192, 256, 4096, 10240]
    assert cost.MEMORY_LADDER_MB == jax_cost.MEMORY_LADDER_MB
    assert cost.workload_cost_usd(ex, mem) == \
        jax_cost.workload_cost_usd(ex, mem)
    assert cost.cost_ladder(ex) == jax_cost.cost_ladder(ex)
    for e, m in zip(ex, mem):
        assert cost.invocation_cost_usd(e, m, 1.3) == \
            jax_cost.invocation_cost_usd(e, m, 1.3)
        assert cost.price_per_ms(m) == jax_cost.price_per_ms(m)
