"""The Scenario half of the port's batched Monte-Carlo engine on the CPU
(the kernel's plain version) against the JAX package: the regime gate
``supported`` (same refusal key and message), ``run_scenarios`` against
the scalar ``repro.run`` (per-task digests with cpu_time, ``summary()``
and the fleet bookkeeping, bit for bit), and ``MonteCarlo`` against JAX's
``MonteCarlo`` rows. JAX's batched engine cannot run here (ROADMAP.md
§3), so the batched port is held to JAX's scalar engine.

    pytest -q tests/test_torch_montecarlo.py
"""
import dataclasses
import importlib
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro.mc as jmc  # noqa: E402
import repro.mc.engine as jengine  # noqa: E402
import repro.traces  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.traces  # noqa: E402
from conftest import mk_tasks  # noqa: E402
from repro.mc.dispatch import reason_key as jax_reason_key  # noqa: E402
from repro_torch.core.events import Task  # noqa: E402
from repro_torch.mc import (MonteCarlo, MonteCarloResult,  # noqa: E402
                            run_scenarios, supported)
from repro_torch.mc import engine  # noqa: E402
from repro_torch.mc.dispatch import reason_key  # noqa: E402
from repro_torch.mc.engine import (cell_params, replay_assignments,  # noqa: E402
                                   scenario_cell)

SMOKE = dict(minutes=1, invocations_per_min=60.0, n_functions=10, seed=0)
FLEET = dict(minutes=1, invocations_per_min=120.0, n_functions=10, seed=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version steps through thousands of tiny tensor ops: torch's
    intra-op threads only spin on them beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(pkg, policy="cfs", n_cores=4, trace=SMOKE, n_nodes=1,
             dispatcher=None, seed=5, fleet=None, pol=None, **kw):
    """The same Scenario in either package (``pkg`` is its module)."""
    return pkg.Scenario(
        workload=pkg.WorkloadSpec(kind="azure",
                                  trace=pkg.traces.TraceSpec(**trace)),
        fleet=pkg.FleetSpec(n_nodes=n_nodes, cores_per_node=n_cores,
                            dispatcher=dispatcher, seed=seed,
                            **(fleet or {})),
        policy=pkg.PolicySpec(name=policy, kw=kw, **(pol or {})))


def both(**kw):
    return scenario(repro, **kw), scenario(repro_torch, **kw)


def digest(res):
    """Exact per-task observables; repr() compares floats bit for bit."""
    return sorted((t.tid, repr(t.completion), t.preemptions, t.ctx_switches,
                   repr(t.first_run), t.migrations, repr(t.cpu_time))
                  for t in res.raw.tasks)


def assert_fleet_equal(got, want):
    """Every field of the ClusterResult equal, each node's task set too
    (a node lists its tasks in dispatch order, as JAX's batched engine
    does; ClusterSim's own order differs and no roll-up reads it)."""
    for f in dataclasses.fields(want.raw):
        if f.name == "node_results":
            assert len(got.raw.node_results) == len(want.raw.node_results)
            for g, w in zip(got.raw.node_results, want.raw.node_results):
                assert sorted(t.tid for t in g.tasks) \
                    == sorted(t.tid for t in w.tasks)
                assert g.total_ctx == w.total_ctx
            continue
        assert getattr(got.raw, f.name) == getattr(want.raw, f.name), f.name


# -- the gate ------------------------------------------------------------------

REFUSALS = {
    "state_aware_fleet": dict(n_nodes=2, dispatcher="least_loaded"),
    "containers": dict(fleet={"containers": "fixed"}),
    "policy": dict(policy="fifo_quantum"),
    "microvm": dict(policy="hybrid", pol={"microvm": True}),
    "adaptive": dict(policy="hybrid", pol={"adapt_pct": 95.0}),
    "policy_n_fifo": dict(policy="hybrid", pol={"n_fifo": 2}),
    "kwargs": dict(sched_latency_ms=10.0),
    "hybrid_n_fifo_0": dict(policy="hybrid", n_fifo=0),
    "hybrid_n_fifo_C": dict(policy="hybrid", n_fifo=4),
    "fleet_default_dispatcher": dict(n_nodes=3),
    "ghost": dict(policy="cfs", pol={"ghost_mode": True}),
    "rightsize": dict(policy="hybrid", pol={"rightsize": True}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_gate_refuses_as_jax_does(case):
    js, ts = both(**REFUSALS[case])
    want, got = jmc.supported(js), supported(ts)
    assert want is not None and got is not None
    assert (reason_key(got), str(got)) == (jax_reason_key(want), str(want))


def _layered(pkg, kind):
    """A scenario with one layer the gate refuses, in either package."""
    sc = scenario(pkg)
    if kind == "retry":
        retry = importlib.import_module(f"{pkg.__name__}.cluster.retry")
        return replace(sc, resilience=pkg.ResilienceSpec(
            retry=retry.RetryPolicy()))
    if kind == "topology":
        topo = importlib.import_module(f"{pkg.__name__}.cluster.topology")
        return replace(sc, fleet=pkg.FleetSpec(
            n_nodes=2, cores_per_node=4, dispatcher="round_robin",
            topology=topo.TopologySpec(zones=("z0",), racks_per_zone=2)))
    if kind == "hetero_nodes":
        return replace(sc, fleet=pkg.FleetSpec(
            n_nodes=2, cores_per_node=4, dispatcher="round_robin",
            nodes=[pkg.PolicySpec(name="cfs")] * 2))
    return replace(sc, workload=pkg.WorkloadSpec(kind="llm"))


@pytest.mark.parametrize("kind", ["retry", "topology", "hetero_nodes",
                                  "llm_workload"])
def test_gate_refuses_layers_as_jax_does(kind):
    want = jmc.supported(_layered(repro, kind))
    got = supported(_layered(repro_torch, kind))
    assert want is not None
    assert (reason_key(got), str(got)) == (jax_reason_key(want), str(want))


@pytest.mark.parametrize("dispatcher", [None, "round_robin", "random"])
@pytest.mark.parametrize("policy", ["fifo", "cfs", "hybrid"])
def test_gate_accepts_what_jax_accepts(policy, dispatcher):
    n = 1 if dispatcher is None else 3
    js, ts = both(policy=policy, n_nodes=n, dispatcher=dispatcher)
    assert jmc.supported(js) is None and supported(ts) is None
    js, ts = both(policy="hybrid", n_fifo=1, time_limit_ms=500.0,
                  n_nodes=n, dispatcher=dispatcher)
    assert jmc.supported(js) is None and supported(ts) is None


def test_scenario_cell_params_equal_jax():
    for kw in ({}, {"n_fifo": 3, "time_limit_ms": 250.0}):
        for policy in ("fifo", "cfs", "hybrid") if not kw else ("hybrid",):
            js, ts = both(policy=policy, n_cores=8, **kw)
            c = scenario_cell(ts, [])
            assert cell_params(c.policy, c.n_cores, c.kw) \
                == jengine.cell_params(js)


@pytest.mark.parametrize("dispatcher", ["round_robin", "random"])
def test_replay_assignments_equal_jax(dispatcher):
    js, ts = both(n_nodes=3, dispatcher=dispatcher, seed=11)
    assert replay_assignments(ts, 200) \
        == jengine.replay_assignments(js, 200)
    with pytest.raises(ValueError, match="not replayable"):
        replay_assignments(scenario(repro_torch, n_nodes=2,
                                    dispatcher="least_loaded"), 5)


# -- run_scenarios against the scalar engine ------------------------------------

@pytest.mark.parametrize("kw", [
    dict(policy="fifo"), dict(policy="cfs"), dict(policy="hybrid"),
    dict(policy="hybrid", n_fifo=1),
    dict(policy="hybrid", n_fifo=3, time_limit_ms=400.0),
], ids=["fifo", "cfs", "hybrid", "hybrid_n_fifo_1", "hybrid_knobs"])
def test_single_node_equals_scalar(kw):
    js, ts = both(**kw)
    want = repro.run(js)
    got = run_scenarios([ts], device="cpu")[0]
    assert digest(got) == digest(want)
    assert got.summary() == want.summary()
    assert got.meta == want.meta
    assert got.mc_stats["events"] > 0


@pytest.mark.parametrize("dispatcher", ["round_robin", "random"])
@pytest.mark.parametrize("policy", ["fifo", "cfs", "hybrid"])
def test_flat_fleet_equals_scalar(policy, dispatcher):
    """The rebuilt ClusterResult is ClusterSim's: roster, assignments in
    dispatch order, node_meta, and every other field."""
    js, ts = both(policy=policy, n_nodes=3, dispatcher=dispatcher,
                  trace=FLEET)
    want = repro.run(js)
    got = run_scenarios([ts], device="cpu")[0]
    assert digest(got) == digest(want)
    assert got.summary() == want.summary()
    assert got.raw.assignments == want.raw.assignments
    assert got.raw.node_ids == want.raw.node_ids
    assert got.raw.node_policies == want.raw.node_policies
    assert got.raw.node_meta == want.raw.node_meta
    assert_fleet_equal(got, want)


def test_mixed_batch_one_launch_a_bucket(monkeypatch):
    """Single nodes and fleets of two core counts in one call: one
    run_grid call a (cores, slots) bucket, every result the scalar one,
    a fleet's mc_stats the sum over its node cells."""
    calls = []
    real = engine.run_grid

    def spy(*args, n_cores, device):
        calls.append((n_cores, args[0].shape))
        return real(*args, n_cores=n_cores, device=device)

    monkeypatch.setattr(engine, "run_grid", spy)
    specs = [dict(policy="cfs"), dict(policy="hybrid", n_cores=6),
             dict(policy="fifo", n_nodes=3, dispatcher="round_robin",
                  trace=FLEET),
             dict(policy="cfs", n_nodes=2, dispatcher="random", n_cores=6)]
    pairs = [both(**kw) for kw in specs]
    got = run_scenarios([t for _j, t in pairs], device="cpu")
    launched = list(calls)
    for (j, _t), res in zip(pairs, got):
        want = repro.run(j)
        assert digest(res) == digest(want)
        assert res.summary() == want.summary()
    # the single nodes' 94 tasks pad to 128 slots, the fleets' nodes
    # (33 and 47 tasks) to 64
    assert sorted((C, N) for C, (_B, N) in launched) \
        == [(4, 64), (4, 128), (6, 64), (6, 128)]
    assert sum(B for _C, (B, _N) in launched) == 1 + 1 + 3 + 2

    # mc_stats of the round_robin fleet: the sum over its node cells
    ts = pairs[2][1]
    tasks = ts.workload.build()[0]
    sel = replay_assignments(ts, len(tasks))
    per = [engine._launch([scenario_cell(ts, [t for t, s in zip(tasks, sel)
                                              if s == i])], "cpu")[0]
           for i in range(3)]
    assert got[2].mc_stats == {"iters": sum(p["iters"] for p in per),
                               "events": sum(p["events"] for p in per)}


def test_empty_node_gets_no_kernel_cell(monkeypatch):
    rows = []
    real = engine.run_grid

    def spy(*args, n_cores, device):
        rows.append(args[0].shape[0])
        return real(*args, n_cores=n_cores, device=device)

    monkeypatch.setattr(engine, "run_grid", spy)
    tiny = dict(minutes=1, invocations_per_min=3.0, n_functions=2, seed=0)
    js, ts = both(policy="cfs", n_nodes=6, dispatcher="round_robin",
                  trace=tiny)
    n = len(ts.workload.build()[0])
    assert 0 < n < 6
    want = repro.run(js)
    got = run_scenarios([ts], device="cpu")[0]
    assert sum(rows) == n
    assert digest(got) == digest(want) and got.summary() == want.summary()
    assert_fleet_equal(got, want)


def test_tasks_workload_and_prebuilt():
    """kind='tasks' runs when canonical; prebuilt (tasks, meta) pairs are
    used as given; a non-canonical stream is refused by its key."""
    rows = [(0, 100), (10, 300), (20, 50), (20, 700), (900, 40)]
    js = repro.Scenario(workload=repro.WorkloadSpec(kind="tasks",
                                                    tasks=mk_tasks(rows)),
                        fleet=repro.FleetSpec(cores_per_node=2))
    ts = repro_torch.Scenario(
        workload=repro_torch.WorkloadSpec(
            kind="tasks", tasks=[Task(tid=i, arrival=float(a),
                                      service=float(s))
                                 for i, (a, s) in enumerate(rows)]),
        fleet=repro_torch.FleetSpec(cores_per_node=2))
    want = repro.run(js)
    got = run_scenarios([ts], device="cpu")[0]
    assert digest(got) == digest(want) and got.summary() == want.summary()

    sc = scenario(repro_torch, policy="fifo")
    built = sc.workload.build()
    res = run_scenarios([sc], prebuilt=[built], device="cpu")[0]
    assert res.raw.tasks is built[0]
    assert all(t.remaining == 0.0 for t in built[0])

    bad = [Task(tid=0, arrival=50.0, service=5.0),
           Task(tid=1, arrival=0.0, service=5.0)]
    with pytest.raises(ValueError, match="non-decreasing"):
        run_scenarios([sc], prebuilt=[(bad, {})], device="cpu")


def test_out_of_regime_raises():
    for kw in (dict(fleet={"containers": "fixed"}),
               dict(n_nodes=2, dispatcher="least_loaded"),
               dict(policy="hybrid", n_fifo=4)):
        with pytest.raises(ValueError, match="outside the batched regime"):
            run_scenarios([scenario(repro_torch, **kw)], device="cpu")


# -- MonteCarlo -------------------------------------------------------------------

def strip(row):
    return {k: v for k, v in row.items() if k != "backend"}


def test_montecarlo_cells_equal_jax():
    kw = dict(seeds=(3, 4), loads=(0.5, 2.0))
    js, ts = both(policy="hybrid")
    want = jmc.MonteCarlo(js, **kw).cells()
    got = MonteCarlo(ts, **kw).cells()
    assert [(dataclasses.asdict(c.workload.trace), c.workload.load_scale)
            for c in got] \
        == [(dataclasses.asdict(c.workload.trace), c.workload.load_scale)
            for c in want]
    assert [(c.workload.trace.seed, c.workload.load_scale) for c in got] \
        == [(3, 0.5), (3, 2.0), (4, 0.5), (4, 2.0)]
    assert all(c.policy == ts.policy and c.fleet == ts.fleet for c in got)


def test_montecarlo_python_rows_equal_jax():
    kw = dict(seeds=(0, 1), loads=(1.0, 2.0), backend="python")
    js, ts = both(policy="fifo")
    want = jmc.MonteCarlo(js, **kw).run()
    got = MonteCarlo(ts, **kw).run()
    assert got.rows == want.rows
    assert [list(r) for r in got.rows] == [list(r) for r in want.rows]
    assert got.meta == want.meta and got.reasons == want.reasons


@pytest.mark.parametrize("policy", ["cfs", "hybrid"])
def test_montecarlo_torch_rows_equal_jax_python(policy):
    kw = dict(seeds=(0, 1), loads=(0.5, 1.5))
    js, ts = both(policy=policy)
    want = jmc.MonteCarlo(js, backend="python", **kw).run().rows
    out = MonteCarlo(ts, backend="torch", device="cpu", **kw).run()
    got = out.rows
    assert [r["backend"] for r in got] == ["torch"] * 4
    assert [strip(r) for r in got] == [strip(r) for r in want]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert out.meta == {"backends": ["torch"] * 4, "fallback": 0,
                        "fallback_reasons": {}}
    assert all(r.mc_stats["events"] > 0 for r in out.results)


def test_montecarlo_fleet_rows_equal_jax_python():
    kw = dict(seeds=(2,), loads=(1.0,))
    js, ts = both(policy="hybrid", n_nodes=3, dispatcher="random",
                  trace=FLEET)
    want = jmc.MonteCarlo(js, backend="python", **kw).run().rows
    got = MonteCarlo(ts, device="cpu", **kw).run().rows
    assert [strip(r) for r in got] == [strip(r) for r in want]


def test_montecarlo_mixed_grid_falls_back_transparently():
    """An out-of-regime cell runs on the scalar engine; its row says why
    (JAX's summary() would overwrite both keys: ROADMAP.md §3)."""
    js, ts = both(policy="cfs", fleet={"containers": "fixed"})
    out = MonteCarlo(ts, seeds=(0,), loads=(1.0,), backend="torch",
                     device="cpu").run()
    assert out.meta == {"backends": ["python"], "fallback": 1,
                        "fallback_reasons": {"containers": 1}}
    row = out.rows[0]
    assert row["fallback_reason"] == "containers"
    assert row["backend"] == "python" and row["n"] > 0
    want = jmc.MonteCarlo(js, seeds=(0,), loads=(1.0,),
                          backend="jax").cells()
    jrow = {**repro.run(want[0]).summary(), "seed": 0, "load_scale": 1.0}
    assert {k: v for k, v in row.items() if k != "fallback_reason"} \
        == {k: v for k, v in jrow.items() if k != "fallback_reason"}


def test_montecarlo_errors():
    sc = repro_torch.Scenario(
        workload=repro_torch.WorkloadSpec(
            kind="tasks", tasks=[Task(tid=0, arrival=0.0, service=1.0)]),
        fleet=repro_torch.FleetSpec(cores_per_node=2))
    with pytest.raises(ValueError, match="trace-driven"):
        MonteCarlo(sc).cells()
    with pytest.raises(ValueError, match="unknown backend"):
        MonteCarlo(scenario(repro_torch), backend="jax").run()
    assert repro_torch.MonteCarlo is MonteCarlo
    assert repro_torch.MonteCarloResult is MonteCarloResult
