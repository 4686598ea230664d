"""The port's fleet simulator (``repro_torch.cluster``) against the JAX
package's (``repro.cluster``).

The golden entry ``cluster-hybrid-s0`` of ``tests/golden/engine_golden.json``
is reproduced by ``launch/fleet.py``'s run of it, whose record is held to
the file and to ``tests/test_engine_equivalence.py``'s (the file is read,
never written). Every other case runs the same fleet through both packages on
a small trace (1 minute at 300 invocations a minute; the admission cases
at 600, the pre-warm cases 2 minutes at 150) and holds every
field of the port's ``ClusterResult`` to JAX's exactly: each node's
``SimResult`` with every task's every field, the assignments, the shed
and failed tasks, the chaos log, the admission, pre-warm and retry
stats, the dispatcher's learned state and the summary. Floats are
compared exactly: no tolerance.
"""
import copy
import dataclasses
import importlib
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_engine_equivalence import GOLDEN, _POOL, _record  # noqa: E402

PKGS = ("repro", "repro_torch")
SMALL = dict(minutes=1, invocations_per_min=300.0, n_functions=25)
CC = dict(keepalive_ms=30_000.0, cold_jitter=0.0)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def trace(pkg: str, seed: int = 0, **kw):
    traces = mod(pkg, "traces")
    spec = dict(SMALL, seed=seed, **kw)
    return traces.generate_workload(traces.TraceSpec(**spec)).tasks


# -- exact comparison ---------------------------------------------------------

def plain(x):
    """``x`` as plain data: dataclasses by class name and fields, floats
    by ``repr`` (so -0.0, inf and every last bit count), numpy values as
    Python ones. The port's ``SimResult.mc_stats`` (the batched engine's
    field) must be None and is left out."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {f.name: plain(getattr(x, f.name))
               for f in dataclasses.fields(x)}
        if type(x).__name__ == "SimResult":
            assert out.pop("mc_stats", None) is None
            out["redispatches"] = getattr(x, "redispatches", 0)
        return [type(x).__name__, out]
    if isinstance(x, dict):
        return {k if isinstance(k, (str, int)) else repr(plain(k)): plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float):
        return repr(x)
    return x


def same_result(got, want):
    """Every field of a ``SimResult`` / ``ClusterResult`` (every node's,
    every task's) and the summary equal, bit for bit."""
    assert type(got).__name__ == type(want).__name__
    g, w = plain(got), plain(want)
    for key in w[1]:
        assert g[1][key] == w[1][key], key
    assert g == w
    assert plain(got.summary()) == plain(want.summary())
    if hasattr(want, "total_cost_usd"):
        assert repr(got.total_cost_usd()) == repr(want.total_cost_usd())


def both(case):
    """The case's result through JAX's package and through the port."""
    return case("repro_torch"), case("repro")


# -- the golden fleet ---------------------------------------------------------

def test_the_fleet_cases_record_the_golden_entry_as_the_golden_file():
    """``launch/fleet.py``'s run of ``cluster-hybrid-s0`` and its own copy
    of the golden record (which ``chip_smoke.py`` holds to the golden
    file on the card's host) against the file and against
    ``test_engine_equivalence``'s ``_record`` of the port's run.
    (``test_torch_core.py`` runs the entry through ``run_cluster`` too.)"""
    fleet = importlib.import_module("repro_torch.launch.fleet")
    want = json.loads(GOLDEN.read_text())["cluster-hybrid-s0"]
    assert fleet.run_case("cluster-hybrid-s0") == want
    assert fleet.POOL == _POOL
    res = mod("repro_torch", "cluster").ClusterSim(
        n_nodes=3, cores_per_node=8, node_policies="hybrid", seed=0,
        containers=mod("repro_torch", "core.containers").ContainerConfig(
            **_POOL)).run(trace("repro_torch"))
    assert fleet.golden_record(res) == _record("cluster-hybrid-s0", res)


# -- dispatchers --------------------------------------------------------------

def test_the_dispatchers_are_jax_s():
    jax_d = mod("repro", "cluster.dispatch").DISPATCHERS
    port_d = mod("repro_torch", "cluster.dispatch").DISPATCHERS
    assert list(port_d) == list(jax_d)


DISPATCHERS = ("random", "round_robin", "least_loaded", "join_idle_queue",
               "affinity", "warm_affinity", "least_loaded_warm",
               "cost_aware")


@pytest.mark.parametrize("dispatcher", DISPATCHERS)
def test_each_dispatcher_matches_jax(dispatcher):
    def case(pkg):
        cluster = mod(pkg, "cluster")
        containers = mod(pkg, "core.containers")
        sim = cluster.ClusterSim(
            n_nodes=3, cores_per_node=6, node_policies="hybrid",
            dispatcher=dispatcher, seed=1,
            containers=containers.ContainerConfig(keepalive_ms=30_000.0))
        return sim.run(trace(pkg, seed=1))
    got, want = both(case)
    same_result(got, want)
    if dispatcher == "cost_aware":
        assert got.dispatcher_state["n_observed"] > 0


# -- fleets that differ node by node, churn, admission, retry, pre-warm -----

def _heterogeneous(pkg):
    cluster = mod(pkg, "cluster")
    sim = cluster.ClusterSim(
        n_nodes=4, cores_per_node=5,
        node_policies=["hybrid", "cfs", ("fifo", {}),
                       ("hybrid", {"n_fifo": 1})],
        dispatcher="least_loaded", seed=2)
    return sim.run(trace(pkg, seed=2))


def _chaos(pkg):
    cluster = mod(pkg, "cluster")
    containers = mod(pkg, "core.containers")
    chaos = cluster.ChaosSchedule(events=(
        cluster.ChaosEvent(t=15_000.0, action="kill", node="node1"),
        cluster.ChaosEvent(t=25_000.0, action="flush_warm", node="node0"),
        cluster.ChaosEvent(t=35_000.0, action="heal", spec="cfs"),
        cluster.ChaosEvent(t=40_000.0, action="kill", node="node9"),
    ), heal_spec="hybrid")
    sim = cluster.ClusterSim(
        n_nodes=3, cores_per_node=6, dispatcher="warm_affinity", seed=3,
        containers=containers.ContainerConfig(**CC))
    return sim.run(trace(pkg, seed=3), chaos=chaos)


def _kill_heal(pkg):
    cluster = mod(pkg, "cluster")
    sim = cluster.ClusterSim(n_nodes=3, cores_per_node=6,
                             dispatcher="affinity", seed=4)
    return sim.run(trace(pkg, seed=4),
                   chaos=cluster.kill_heal(20_000.0, 30_000.0))


def _churn(pkg):
    cluster = mod(pkg, "cluster")
    containers = mod(pkg, "core.containers")
    sim = cluster.ClusterSim(
        n_nodes=3, cores_per_node=6, dispatcher="cost_aware", seed=5,
        containers=containers.ContainerConfig(**CC))
    return sim.run(trace(pkg, seed=5),
                   chaos=cluster.churn_preset(60_000.0))


def _admission(action, **kw):
    def case(pkg):
        cluster = mod(pkg, "cluster")
        adm = cluster.AdmissionConfig(overload_action=action, **kw)
        sim = cluster.ClusterSim(n_nodes=2, cores_per_node=3,
                                 dispatcher="affinity", seed=6,
                                 admission=adm)
        return sim.run(trace(pkg, seed=6, invocations_per_min=600.0))
    return case


def _rate_limit(action):
    def case(pkg):
        cluster = mod(pkg, "cluster")
        adm = cluster.AdmissionConfig(rate_per_s=0.3, burst=2.0,
                                      rate_action=action,
                                      max_queue_ms=5_000.0)
        sim = cluster.ClusterSim(n_nodes=2, cores_per_node=4, seed=7,
                                 admission=adm)
        return sim.run(trace(pkg, seed=7))
    return case


def _retry(budget, breaker):
    def case(pkg):
        cluster = mod(pkg, "cluster")
        chaos = cluster.ChaosSchedule(events=(
            cluster.ChaosEvent(t=10_000.0, action="kill", node="node0"),
            cluster.ChaosEvent(t=20_000.0, action="kill", node="node1"),
            cluster.ChaosEvent(t=30_000.0, action="heal"),
        ))
        sim = cluster.ClusterSim(n_nodes=3, cores_per_node=2, seed=8)
        return sim.run(trace(pkg, seed=8), chaos=chaos,
                       retry=cluster.RetryPolicy(
                           budget=budget, breaker_threshold=breaker,
                           breaker_window_ms=20_000.0))
    return case


def _prewarm(forecast):
    def case(pkg):
        cluster = mod(pkg, "cluster")
        containers = mod(pkg, "core.containers")
        # two minutes: the forecaster provisions a minute from the ones
        # before it
        tasks = trace(pkg, seed=9, minutes=2, invocations_per_min=150.0)
        cfg = cluster.PrewarmConfig(lead_ms=2_000.0, min_per_min=2,
                                    forecast=forecast)
        sim = cluster.ClusterSim(
            n_nodes=3, cores_per_node=6, dispatcher="warm_affinity",
            seed=9, containers=containers.ContainerConfig(**CC))
        return sim.run(tasks, prewarm=cluster.Provisioner.from_workload(
            tasks, cfg))
    return case


def _topology(pkg):
    cluster = mod(pkg, "cluster")
    containers = mod(pkg, "core.containers")
    topo = cluster.TopologySpec(
        zones=("z0", "z1"), racks_per_zone=2, nodes_per_rack=1,
        sku_pattern=("std", "spot", "turbo", "value"), cross_zone_ms=30.0,
        heal_zone="z0")
    sim = cluster.ClusterSim(
        cores_per_node=5, dispatcher="cost_aware", seed=10,
        containers=containers.ContainerConfig(**CC), topology=topo)
    return sim.run(trace(pkg, seed=10),
                   chaos=cluster.zone_failure_preset(60_000.0),
                   retry=cluster.RetryPolicy(budget=8, breaker_threshold=0))


def _degrade(pkg):
    cluster = mod(pkg, "cluster")
    topo = cluster.TopologySpec(zones=("a", "b", "c"), racks_per_zone=1,
                                nodes_per_rack=2, sku_pattern=("value",
                                                               "turbo"))
    chaos = cluster.ChaosSchedule(events=(
        cluster.ChaosEvent(t=5_000.0, action="degrade", zone="b",
                           severity=0.4),
        cluster.ChaosEvent(t=12_000.0, action="kill_rack", rack="c-r0"),
        cluster.ChaosEvent(t=30_000.0, action="restore", zone="b"),
        cluster.ChaosEvent(t=35_000.0, action="heal"),
    ))
    sim = cluster.ClusterSim(cores_per_node=4, dispatcher="least_loaded",
                             seed=11, topology=topo)
    return sim.run(trace(pkg, seed=11), chaos=chaos)


def _slot_cap(pkg):
    cluster = mod(pkg, "cluster")
    containers = mod(pkg, "core.containers")
    sim = cluster.ClusterSim(
        n_nodes=2, cores_per_node=6, dispatcher="affinity", seed=12,
        containers=containers.ContainerConfig(max_concurrency=2, **CC))
    return sim.run(trace(pkg, seed=12))


def _run_cluster_shim(pkg):
    cluster = mod(pkg, "cluster")
    with pytest.warns(DeprecationWarning):
        return cluster.run_cluster(
            trace(pkg, seed=13), n_nodes=2, cores_per_node=6,
            node_policy=("hybrid", {"n_fifo": 2}), dispatcher="round_robin",
            seed=13, containers="fixed",
            admission=cluster.AdmissionConfig(max_load=1.0,
                                              overload_action="spill"))


CASES = {
    "heterogeneous": _heterogeneous,
    "chaos-kill-flush-heal": _chaos,
    "chaos-kill_heal": _kill_heal,
    "chaos-churn_preset": _churn,
    "admission-shed": _admission("shed", max_load=1.0),
    "admission-queue": _admission("queue", max_load=1.0,
                                  queue_backoff_ms=100.0,
                                  max_queue_ms=4_000.0),
    "admission-spill": _admission("spill", max_load=1.0),
    "rate-shed": _rate_limit("shed"),
    "rate-queue": _rate_limit("queue"),
    "retry-backoff": _retry(8, 0),
    "retry-breaker": _retry(3, 4),
    "prewarm-oracle": _prewarm("oracle"),
    "prewarm-ewma": _prewarm("ewma"),
    "topology-zone-failure": _topology,
    "topology-degrade-kill_rack": _degrade,
    "slot-cap": _slot_cap,
    "run_cluster-shim": _run_cluster_shim,
}


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_case_matches_jax(case):
    got, want = both(CASES[case])
    same_result(got, want)
    s = got.summary()
    assert s["n"] + s["failed"] + s["shed"] > 0
    # the layer the case is about did something
    if case.startswith(("chaos", "topology")):
        assert got.chaos_events
    if case.startswith(("admission", "rate")):
        assert s["shed"] + s["queued"] + s["spilled"] > 0
    if case.startswith("retry"):
        assert s["retries"] > 0
    if case.startswith("prewarm"):
        assert s["prewarmed"] > 0
    if case == "topology-zone-failure":
        assert s["revoked"] > 0 and s["spot_savings_usd"] > 0.0


# -- the pieces on their own --------------------------------------------------

def test_topology_retry_and_admission_pieces_match_jax():
    out = {}
    for pkg in PKGS:
        cl = mod(pkg, "cluster")
        topo = cl.TopologySpec(zones=("a", "b", "c"), racks_per_zone=2,
                               nodes_per_rack=2,
                               sku_pattern=("std", "spot", "turbo"))
        st = cl.RetryState(cl.RetryPolicy(base_ms=50.0, cap_ms=900.0,
                                          jitter_frac=0.5, budget=3,
                                          breaker_threshold=4), seed=4)
        adm = cl.AdmissionControl(cl.AdmissionConfig(rate_per_s=2.0,
                                                     burst=3.0))
        tasks = trace(pkg, seed=14)
        plan = cl.build_plan(tasks, cl.PrewarmConfig(lead_ms=1_000.0))
        fc = mod(pkg, "costmodel.forecast").build_forecast_plan(tasks)
        out[pkg] = plain([
            topo.placement(), topo.heal_placement(),
            [topo.home_zone(f) for f in range(7)],
            {k: (v.effective_price_mult, cl.topology.SlowdownDial(
                v.clock, 0.25)(0.0)) for k, v in cl.SKUS.items()},
            [st.policy.backoff_ms(a, t, seed=4) for t in range(5)
             for a in range(1, 6)],
            [st.on_failure(t, t.arrival) for t in tasks[:40]],
            st.stats(),
            [adm._bucket_wait_ms(t, t.arrival) for t in tasks[:60]],
            adm.stats(),
            plan, fc])
    assert out["repro_torch"] == out["repro"]


def test_shard_tasks_and_workload_file_match_jax():
    out = {}
    for pkg in PKGS:
        tr = mod(pkg, "traces")
        w = tr.generate_workload(tr.TraceSpec(**SMALL, seed=15))
        out[pkg] = plain([
            [[t.tid for t in s] for s in tr.shard_tasks(w.tasks, 3)],
            [[t.tid for t in s]
             for s in tr.shard_tasks(w.tasks, 4, by="interleave")],
            tr.workload_file(w)])
    assert out["repro_torch"] == out["repro"]
    with pytest.raises(KeyError):
        mod("repro_torch", "traces").shard_tasks([], 2, by="zone")
    with pytest.raises(ValueError):
        mod("repro_torch", "traces").shard_tasks([], 0)


def test_cost_helpers_match_jax():
    out = {}
    for pkg in PKGS:
        cost = mod(pkg, "core.cost")
        ex = [12.5, 3e3, 0.25, 1e-3]
        mem = [128, 512, 3008, 10240]
        with pytest.warns(DeprecationWarning):
            consts = [cost.PRICE_PER_GB_SECOND, cost.PRICE_PER_REQUEST,
                      cost.WARM_HOLD_PER_GB_SECOND]
        out[pkg] = plain([
            cost.duration_cost_usd(ex, mem),
            cost.rejected_request_cost_usd(37), consts,
            cost.AZURE_MEMORY_DISTRIBUTION,
            cost.sample_memory_sizes(50, np.random.default_rng(3))])
    assert out["repro_torch"] == out["repro"]
    with pytest.raises(AttributeError):
        mod("repro_torch", "core.cost").NO_SUCH_CONSTANT
    assert math.isclose(sum(p for _, p in mod(
        "repro_torch", "core.cost").AZURE_MEMORY_DISTRIBUTION), 1.0)


def test_the_fleet_is_deterministic_and_leaves_its_input_alone():
    tasks = trace("repro_torch", seed=16)
    before = copy.deepcopy(tasks)
    cluster = mod("repro_torch", "cluster")
    runs = [cluster.ClusterSim(n_nodes=3, cores_per_node=6,
                               dispatcher="random", seed=16).run(tasks)
            for _ in range(2)]
    assert plain(runs[0]) == plain(runs[1])
    assert plain(tasks) == plain(before)
