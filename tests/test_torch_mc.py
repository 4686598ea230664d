"""The port's batched Monte-Carlo engine on the CPU (the plain version,
``run_grid_plain``, through ``run_cells``) against the JAX package's
scalar engine ``repro.run``: per-task completion, first_run, cpu_time,
preemptions, ctx_switches and migrations bit for bit, ``SimResult.summary``
equal to the scalar one, and the scheduling-event count equal to the
scalar scheduler's. Also the regime refusals, the event cap and the
front door's checks.

    pytest -q tests/test_torch_mc.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from conftest import mk_tasks  # noqa: E402
from repro import FleetSpec, PolicySpec, Scenario, WorkloadSpec  # noqa: E402
from repro.core.simulate import make_scheduler  # noqa: E402
from repro.traces import TraceSpec as JaxTraceSpec  # noqa: E402
from repro.traces import generate_workload as jax_generate  # noqa: E402
from repro_torch.core.events import Task  # noqa: E402
from repro_torch.kernels import mc_cell  # noqa: E402
from repro_torch.mc import Cell, run_cells, run_grid  # noqa: E402
from repro_torch.mc.dispatch import reason_key, tasks_supported  # noqa: E402
from repro_torch.mc.engine import _bucket, cell_params  # noqa: E402
from repro_torch.traces import (TraceSpec, generate_workload,  # noqa: E402
                                scale_load)

SMOKE = dict(minutes=1, invocations_per_min=60.0, n_functions=10)
BIG = dict(minutes=1, invocations_per_min=600.0, n_functions=40, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version steps through thousands of tiny tensor ops: torch's
    intra-op threads only spin on them, and beside other test workers
    they slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(tasks):
    """Exact per-task observables (the digest of test_mc_equivalence.py
    plus cpu_time); repr() compares floats bit for bit."""
    return sorted((t.tid, repr(t.completion), t.preemptions,
                   t.ctx_switches, repr(t.first_run), t.migrations,
                   repr(t.cpu_time)) for t in tasks)


def scalar(policy, n_cores, spec, load=1.0, **kw):
    return repro.run(Scenario(
        workload=WorkloadSpec(kind="azure", trace=JaxTraceSpec(**spec),
                              load_scale=load),
        fleet=FleetSpec(cores_per_node=n_cores),
        policy=PolicySpec(name=policy, kw=kw))).raw


def scalar_tasks(spec):
    return jax_generate(JaxTraceSpec(**spec)).tasks


def port_tasks(spec, load=1.0):
    tasks = generate_workload(TraceSpec(**spec)).tasks
    return scale_load(tasks, load) if load != 1.0 else tasks


def assert_bit_identical(cells, refs):
    results = run_cells(cells, device="cpu")
    for res, ref in zip(results, refs):
        assert digest(res.tasks) == digest(ref.tasks)
        assert res.summary() == ref.summary()
    return results


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["fifo", "cfs", "hybrid"])
def test_smoke_trace_matches_scalar_engine(policy, seed):
    spec = dict(SMOKE, seed=seed)
    assert_bit_identical([Cell(policy, 4, port_tasks(spec))],
                         [scalar(policy, 4, spec)])


def test_sixteen_cores_at_600_a_minute_match_in_one_grid():
    """Three policies batched into one grid (one bucket, one call)."""
    tasks = port_tasks(BIG)
    pols = ["fifo", "cfs", "hybrid"]
    res = assert_bit_identical([Cell(p, 16, tasks) for p in pols],
                               [scalar(p, 16, BIG) for p in pols])
    for p, r in zip(pols, res):
        sched = make_scheduler(p, n_cores=16)
        sched.run(scalar_tasks(BIG))
        assert r.mc_stats["events"] == sched.n_events


@pytest.mark.parametrize("kw", [
    {"n_fifo": 1}, {"n_fifo": 3}, {"time_limit_ms": 500.0},
    {"n_fifo": 1, "time_limit_ms": 250.0}, "below_shortest"],
    ids=["n_fifo=1", "n_fifo=C-1", "limit=500", "n_fifo=1,limit=250",
         "limit<shortest"])
def test_hybrid_knobs_match_scalar_engine(kw):
    spec = dict(SMOKE, seed=0)
    tasks = port_tasks(spec)
    if kw == "below_shortest":
        kw = {"time_limit_ms": 0.5 * min(t.service for t in tasks)}
    assert_bit_identical([Cell("hybrid", 4, tasks, kw)],
                         [scalar("hybrid", 4, spec, **kw)])


@pytest.mark.parametrize("policy", ["cfs", "hybrid"])
def test_bursts_match_scalar_engine(policy):
    """Arrivals moved onto a 500 ms grid: bursts of same-instant arrivals,
    runqueues through every slice length, ties between expiries."""
    spec = dict(SMOKE, seed=0)
    specs = [(500.0 * (t.arrival // 500.0), t.service)
             for t in port_tasks(spec)]
    ref = repro.run(Scenario(
        workload=WorkloadSpec(kind="tasks", tasks=mk_tasks(specs)),
        fleet=FleetSpec(cores_per_node=2),
        policy=PolicySpec(name=policy))).raw
    tasks = [Task(tid=i, arrival=a, service=s)
             for i, (a, s) in enumerate(specs)]
    assert_bit_identical([Cell(policy, 2, tasks)], [ref])


@pytest.mark.parametrize("load", [0.5, 1.5])
def test_load_scaled_cells_match_scalar_engine(load):
    spec = dict(SMOKE, seed=1)
    pols = ["fifo", "cfs", "hybrid"]
    assert_bit_identical([Cell(p, 4, port_tasks(spec, load)) for p in pols],
                         [scalar(p, 4, spec, load) for p in pols])


def test_cells_share_a_task_list_and_mixed_buckets():
    """run_cells copies the tasks, so cells may share a list; cells of
    other core counts and lengths go to their own buckets."""
    spec = dict(SMOKE, seed=2)
    tasks = port_tasks(spec)
    short = [t for t in tasks if t.tid < 40]
    cells = [Cell("cfs", 4, tasks), Cell("hybrid", 2, tasks),
             Cell("fifo", 4, short), Cell("cfs", 4, tasks)]
    res = run_cells(cells, device="cpu")
    assert all(t.completion is None for t in tasks)
    assert digest(res[0].tasks) == digest(res[3].tasks)
    assert digest(res[0].tasks) == digest(scalar("cfs", 4, spec).tasks)
    assert digest(res[1].tasks) == digest(scalar("hybrid", 2, spec).tasks)
    ref = repro.run(Scenario(
        workload=WorkloadSpec(kind="tasks", tasks=mk_tasks(
            [(t.arrival, t.service, t.mem_mb) for t in short])),
        fleet=FleetSpec(cores_per_node=4), policy=PolicySpec(name="fifo")))
    assert digest(res[2].tasks) == digest(ref.raw.tasks)


def test_run_grid_outputs_and_padding():
    tasks = port_tasks(dict(SMOKE, seed=0))[:30]
    N = _bucket(len(tasks))
    arr = np.full((2, N), np.inf)
    svc = np.full((2, N), 1.0)
    arr[:, :30] = [t.arrival for t in tasks]
    svc[:, :30] = [t.service for t in tasks]
    out = run_grid(arr, svc, np.array([30, 20], np.int32),
                   np.array([0, 2], np.int32), np.array([np.inf, 100.0]),
                   n_cores=4, device="cpu")
    assert set(out) == {"completion", "first_run", "preemptions",
                        "ctx_switches", "migrations", "cpu_time", "ok",
                        "n_iters", "n_events"}
    assert out["completion"].shape == (2, N)
    assert out["completion"].dtype == np.float64
    assert out["preemptions"].dtype == np.int32
    assert out["ok"].tolist() == [True, True]
    assert np.isnan(out["completion"][0, 30:]).all()
    assert np.isnan(out["first_run"][1, 20:]).all()
    assert not np.isnan(out["completion"][1, :20]).any()
    assert (out["cpu_time"][1, 20:] == 0).all()
    assert (out["migrations"][0] == 0).all()
    # one cell alone gives the same bits as inside the grid
    one = run_grid(arr[1:], svc[1:], np.array([20], np.int32),
                   np.array([2], np.int32), np.array([100.0]), n_cores=4,
                   device="cpu")
    for k in ("completion", "first_run", "cpu_time", "preemptions"):
        assert np.array_equal(one[k][0], out[k][1], equal_nan=True)
    assert one["n_events"][0] == out["n_events"][1]


@pytest.mark.parametrize("case", ["n_fifo", "fifo_limit", "order", "nan",
                                  "shape"])
def test_run_grid_refuses_bad_inputs(case):
    arr = np.array([[0.0, 1.0, 2.0, np.inf]])
    svc = np.ones((1, 4))
    n, nf, lim = np.array([3], np.int32), np.array([0], np.int32), \
        np.array([np.inf])
    if case == "n_fifo":
        nf = np.array([5], np.int32)
    elif case == "fifo_limit":
        nf, lim = np.array([4], np.int32), np.array([10.0])
    elif case == "order":
        arr = np.array([[0.0, 2.0, 1.0, np.inf]])
    elif case == "nan":
        svc = np.array([[1.0, np.nan, 1.0, 1.0]])
    else:
        svc = np.ones((1, 3))
    with pytest.raises(ValueError):
        run_grid(arr, svc, n, nf, lim, n_cores=4, device="cpu")


@pytest.mark.parametrize("case", ["stream_tids", "stream_order",
                                  "partial_tasks", "aux_tasks"])
def test_run_cells_raises_on_refused_task_streams(case):
    tasks = [Task(tid=i, arrival=float(10 * i), service=5.0)
             for i in range(4)]
    if case == "stream_tids":
        tasks[2].tid = 7
    elif case == "stream_order":
        tasks[3].arrival = 1.0
    elif case == "partial_tasks":
        tasks[1].remaining = 2.0
    else:
        tasks[0].aux_of = 3
    why = tasks_supported(tasks)
    assert reason_key(why) == case
    with pytest.raises(ValueError, match="outside the batched regime"):
        run_cells([Cell("cfs", 2, tasks)], device="cpu")


@pytest.mark.parametrize("policy, kw, why", [
    ("edf", {}, "not batched"), ("cfs", {"sched_latency_ms": 10.0},
                                 "kwargs"),
    ("hybrid", {"adapter": 95.0}, "kwargs"),
    ("hybrid", {"n_fifo": 0}, "1 <= n_fifo"),
    ("hybrid", {"n_fifo": 4}, "1 <= n_fifo")])
def test_cell_params_refuses_out_of_regime(policy, kw, why):
    with pytest.raises(ValueError, match=why):
        cell_params(policy, 4, kw)


def test_cell_params_and_bucket():
    assert cell_params("fifo", 8, {}) == (8, float("inf"))
    assert cell_params("cfs", 8, {}) == (0, float("inf"))
    assert cell_params("hybrid", 8, {}) == (4, 1633.0)
    assert cell_params("hybrid", 8, {"n_fifo": 3,
                                     "time_limit_ms": 250.0}) == (3, 250.0)
    assert _bucket(1) == 64 and _bucket(64) == 64
    assert _bucket(65) == 128 and _bucket(12643) == 16384


def test_a_cell_that_hits_the_event_cap_raises(monkeypatch):
    """The cap ends a cell that runs on: its ok is False, and run_cells
    raises instead of returning partial results."""
    tasks = port_tasks(dict(SMOKE, seed=0))
    monkeypatch.setattr(mc_cell, "event_caps",
                        lambda service, n_tasks: torch.full_like(
                            n_tasks, 50, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="failed to drain cells \\[1\\]"):
        run_cells([Cell("fifo", 4, tasks[:10]), Cell("cfs", 4, tasks)],
                  device="cpu")


def test_plain_slice_is_the_ieee_quotient():
    """The plain version's CFS slice equals Python's for every queue
    length (a float over a tensor would be a reciprocal product: 24 / 5
    gave 4.800000000000001)."""
    from repro.core.events import cfs_slice_ms
    got = mc_cell.cfs_slice_plain(torch.arange(300))
    assert [repr(x) for x in got.tolist()] == \
        [repr(cfs_slice_ms(nr, 24.0, 3.0)) for nr in range(300)]
    assert mc_cell.slice_table() == got[:len(mc_cell.slice_table())].tolist()


def test_event_caps_bound_the_scalar_event_counts():
    tasks = port_tasks(BIG)
    svc = torch.tensor([[t.service for t in tasks]], dtype=torch.float64)
    cap = int(mc_cell.event_caps(svc, torch.tensor([len(tasks)]))[0])
    for p in ("cfs", "hybrid"):
        sched = make_scheduler(p, n_cores=16)
        sched.run(scalar_tasks(BIG))
        assert sched.n_events < cap


def check_random_grid(arrivals, services, n_cores, policy, limit):
    """Integer arrival times and ladder services make equal-time events
    (arrival / expiry and expiry / expiry ties) common."""
    if policy == "hybrid" and n_cores < 2:
        policy = "cfs"
    specs = [(float(a), services[i]) for i, a in enumerate(sorted(arrivals))]
    kw = {"n_fifo": 1, "time_limit_ms": limit} if policy == "hybrid" else {}
    ref = repro.run(Scenario(
        workload=WorkloadSpec(kind="tasks", tasks=mk_tasks(specs)),
        fleet=FleetSpec(cores_per_node=n_cores),
        policy=PolicySpec(name=policy, kw=kw))).raw
    tasks = [Task(tid=i, arrival=a, service=s)
             for i, (a, s) in enumerate(specs)]
    res = run_cells([Cell(policy, n_cores, tasks, kw)], device="cpu")[0]
    assert digest(res.tasks) == digest(ref.tasks)
    assert res.summary() == ref.summary()


def test_random_small_grids_match_scalar_engine():
    hyp = pytest.importorskip(
        "hypothesis", reason="install the [test] extra for property tests")
    st = pytest.importorskip("hypothesis.strategies")
    sweep = hyp.settings(max_examples=30, deadline=None)(
        hyp.example(arrivals=[0] * 6,
                    services=[40.0, 7.25, 1e-10, 1e-10, 3.0, 0.5]
                    + [1e-10] * 4, n_cores=1, policy="cfs", limit=0.001)(
        hyp.given(
            arrivals=st.lists(st.integers(0, 40), min_size=1, max_size=10),
            services=st.lists(st.sampled_from(
                [1e-10, 0.5, 3.0, 7.25, 24.0, 40.0, 100.0, 333.3]),
                min_size=10, max_size=10),
            n_cores=st.integers(1, 4),
            policy=st.sampled_from(["fifo", "cfs", "hybrid"]),
            limit=st.sampled_from([0.001, 5.0, 50.0, 1633.0]))(
            check_random_grid)))
    sweep()
