"""The port's Scenario API (``repro_torch.run``) against the JAX
package's (``repro.run``).

Each case builds the same ``Scenario`` in both packages and holds the
port's ``ScenarioResult`` to JAX's exactly: the raw result's every field
(every node's, every task's), the summary and the workload's meta. The
learned cost model is fed the same artifact dict in both packages: the
synthetic calibration, and a measured one (the port's measure mode on
the CPU, which times the plain versions). The deprecated shims
(``run_policy``, ``run_cluster``, ``run_gateway``, ``run_gateway_fleet``)
equal the Scenario each builds, and the summary schema and the lazy
exports are JAX's.
"""
import copy
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import both, mod, plain, same_result  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(minutes=1, invocations_per_min=240.0, n_functions=16)
LLM_TRACE = dict(minutes=2, invocations_per_min=40.0, n_functions=6)


def _api(pkg):
    sc = mod(pkg, "scenario")
    return sc, mod(pkg, "traces").TraceSpec


@pytest.fixture(scope="module")
def artifacts():
    """The artifacts both packages' learned runs get, as the same dicts:
    JAX's synthetic calibration, and a measured one from the port's
    measure mode on the CPU."""
    cal = importlib.import_module("repro_torch.costmodel.calibrate")
    synthetic = importlib.import_module(
        "repro.costmodel.calibrate").calibrate(mode="synthetic", seed=0)
    assert cal.calibrate(mode="synthetic", seed=0) == synthetic
    measured = cal.calibrate(mode="measure", device="cpu", repeats=2)
    assert measured["mode"] == "measure"
    return {"synthetic": synthetic, "measured": measured}


def same_scenario(got, want):
    same_result(got.raw, want.raw)
    assert plain(got.summary()) == plain(want.summary())
    assert plain(got.meta) == plain(want.meta)
    assert got.n_requests == want.n_requests
    assert repr(got.usd_per_1k_requests()) == repr(want.usd_per_1k_requests())


def _azure_single(pkg):
    sc, TraceSpec = _api(pkg)
    return sc.run(sc.Scenario(
        workload=sc.WorkloadSpec(kind="azure",
                                 trace=TraceSpec(**SMALL, seed=1)),
        fleet=sc.FleetSpec(cores_per_node=8, containers="fixed"),
        policy=sc.PolicySpec(name="hybrid", adapt_pct=90.0,
                             rightsize=True)))


def _azure_single_scaled(pkg):
    sc, TraceSpec = _api(pkg)
    return sc.run(sc.Scenario(
        workload=sc.WorkloadSpec(kind="synthetic", load_scale=1.5,
                                 trace=TraceSpec(**SMALL, seed=2)),
        fleet=sc.FleetSpec(cores_per_node=6),
        policy=sc.PolicySpec(name="cfs", ghost_mode=True),
        pricing="premium"))


def _azure_fleet(pkg):
    sc, TraceSpec = _api(pkg)
    return sc.run(sc.Scenario(
        workload=sc.WorkloadSpec(kind="azure",
                                 trace=TraceSpec(**SMALL, seed=3)),
        fleet=sc.FleetSpec(n_nodes=3, cores_per_node=6,
                           dispatcher="warm_affinity",
                           containers={"keepalive_ms": 20_000.0}, seed=3),
        policy=sc.PolicySpec(name="hybrid", n_fifo=2, adapt_pct=95.0),
        resilience=sc.ResilienceSpec(
            admission={"max_load": 2.0, "overload_action": "queue"},
            prewarm={"lead_ms": 1_000.0}),
        pricing={"price_per_request": 0.0}))


def _azure_fleet_nodes(pkg):
    sc, TraceSpec = _api(pkg)
    topo = mod(pkg, "cluster").TopologySpec(
        zones=("z0", "z1"), racks_per_zone=1, nodes_per_rack=2,
        sku_pattern=("std", "spot"))
    return sc.run(sc.Scenario(
        workload=sc.WorkloadSpec(kind="azure",
                                 trace=TraceSpec(**SMALL, seed=4)),
        fleet=sc.FleetSpec(cores_per_node=5, dispatcher="cost_aware",
                           containers="histogram", topology=topo,
                           nodes=["hybrid", "cfs", "fifo", "hybrid"]),
        policy=sc.PolicySpec(name="hybrid"),
        resilience=sc.ResilienceSpec(retry={"budget": 4}),
        pricing="free_requests"))


def _tasks(fresh):
    def case(pkg):
        sc, TraceSpec = _api(pkg)
        tr = mod(pkg, "traces")
        tasks = tr.generate_workload(TraceSpec(**SMALL, seed=5)).tasks
        before = copy.deepcopy(tasks)
        res = sc.run(sc.Scenario(
            workload=sc.WorkloadSpec(kind="tasks", tasks=tasks,
                                     fresh=fresh),
            fleet=sc.FleetSpec(cores_per_node=8),
            policy=sc.PolicySpec(name="edf")))
        # fresh runs copies; fresh=False runs the caller's objects
        assert (plain(tasks) == plain(before)) is fresh
        res.meta["inputs"] = plain(tasks)
        return res
    return case


def _llm(fleet, cost_model=None, model="deepseek-7b"):
    def case(pkg, artifacts=None):
        sc, TraceSpec = _api(pkg)
        llm = mod(pkg, "serving.llm")
        cm = cost_model
        if cm is not None and artifacts is not None:
            cm = dict(artifacts[cm])
        if fleet:
            fl = sc.FleetSpec(n_nodes=2, cores_per_node=4,
                              dispatcher="cost_aware", seed=6)
            res = sc.ResilienceSpec(
                admission={"max_load": "auto", "overload_action": "queue"},
                prewarm={"lead_ms": 1_000.0})
        else:
            fl, res = sc.FleetSpec(cores_per_node=4), sc.ResilienceSpec()
        return sc.run(sc.Scenario(
            workload=sc.WorkloadSpec(kind="llm",
                                     trace=TraceSpec(**LLM_TRACE, seed=6),
                                     llm=llm.LLMSpec(model=model)),
            fleet=fl, policy=sc.PolicySpec(name="hybrid"), resilience=res,
            cost_model=cm))
    return case


def _admission_config_auto(pkg, artifacts=None):
    """``max_load="auto"`` in the AdmissionConfig form."""
    sc, TraceSpec = _api(pkg)
    cluster = mod(pkg, "cluster")
    return sc.run(sc.Scenario(
        workload=sc.WorkloadSpec(kind="azure",
                                 trace=TraceSpec(**SMALL, seed=7)),
        fleet=sc.FleetSpec(n_nodes=2, cores_per_node=3,
                           dispatcher="cost_aware", seed=7),
        resilience=sc.ResilienceSpec(admission=cluster.AdmissionConfig(
            max_load="auto", overload_action="shed",
            max_queue_ms=2_000.0)),
        cost_model=dict(artifacts["synthetic"])))


CASES = {
    "azure-single": _azure_single,
    "azure-single-scaled-ghost-premium": _azure_single_scaled,
    "azure-fleet-admission-prewarm": _azure_fleet,
    "azure-fleet-topology-nodes-retry": _azure_fleet_nodes,
    "tasks-fresh": _tasks(True),
    "tasks-in-place": _tasks(False),
    "llm-static-single": _llm(False),
    "llm-static-fleet": _llm(True),
    "llm-learned-synthetic-single": _llm(False, "synthetic"),
    "llm-learned-synthetic-fleet": _llm(True, "synthetic"),
    "llm-learned-measured-fleet": _llm(True, "measured"),
    "llm-learned-measured-transfer": _llm(True, "measured", "zamba2-1.2b"),
    "admission-config-auto": _admission_config_auto,
}
LEARNED = ("llm-learned", "admission-config-auto")


@pytest.mark.parametrize("case", list(CASES))
def test_scenario_matches_jax(case, artifacts):
    fn = CASES[case]
    if case.startswith(LEARNED):
        got, want = fn("repro_torch", artifacts), fn("repro", artifacts)
    else:
        got, want = both(fn)
    same_scenario(got, want)
    s = got.summary()
    assert s["n"] > 0
    if "learned" in case and "fleet" in case:
        assert s["cost_model"] == "learned" and s["cost_obs"] > 0
        # the EWMA forecaster asked for sandboxes
        assert got.raw.prewarm_stats["requested"] > 0


def test_the_learned_model_prices_a_transferred_model_by_its_fit(
        artifacts):
    """At its reference model and seq the artifact's token costs are the
    spec's constants, so the fit's weights move nothing there; another
    model's costs are transferred by the fit's ratios."""
    model = importlib.import_module("repro_torch.costmodel.model")
    configs = importlib.import_module("repro_torch.configs")
    syn = model.LearnedCostModel(dict(artifacts["synthetic"]))
    mea = model.LearnedCostModel(dict(artifacts["measured"]))
    ref = configs.get_config("deepseek-7b")
    assert syn.token_costs(ref, 4096) == mea.token_costs(ref, 4096) == (
        ref.ms_per_ktoken_prefill, ref.ms_per_token_decode)
    other = configs.get_config("zamba2-1.2b")
    assert syn.token_costs(other, 4096) != mea.token_costs(other, 4096)


def test_the_cost_model_bench_scenario_matches_jax(artifacts):
    """The cost-model bench's scenario (``launch/fleet.py``'s
    ``llm-small``), static and learned, through each package's API."""
    fleet = importlib.import_module("repro_torch.launch.fleet")
    jax_api = type(fleet.port_api())(**{
        name: getattr(importlib.import_module(f"repro.{m}"), name)
        for m, names in fleet.API.items() for name in names})
    for cm in (None, artifacts["synthetic"], artifacts["measured"]):
        assert fleet.run_case("llm-small", cm) == \
            fleet.run_case("llm-small", cm, api=jax_api)
        got = importlib.import_module("repro_torch.scenario").run(
            fleet.llm_scenario(fleet.port_api(), "small",
                               cm and dict(cm)))
        want = importlib.import_module("repro.scenario").run(
            fleet.llm_scenario(jax_api, "small", cm and dict(cm)))
        same_scenario(got, want)


def test_the_transferred_scenario_matches_jax_and_follows_the_weights(
        artifacts):
    """``launch/fleet.py``'s ``llm-transfer`` (the bench's scenario
    serving zamba2-1.2b) through each package's API: a learned run
    prices zamba2-1.2b's tokens by the fit's ratios, so the measured and
    the synthetic weights give different records."""
    fleet = importlib.import_module("repro_torch.launch.fleet")
    jax_api = type(fleet.port_api())(**{
        name: getattr(importlib.import_module(f"repro.{m}"), name)
        for m, names in fleet.API.items() for name in names})
    recs = {}
    for key in ("synthetic", "measured"):
        recs[key] = fleet.run_case("llm-transfer", artifacts[key])
        assert recs[key] == fleet.run_case("llm-transfer", artifacts[key],
                                           api=jax_api)
        assert recs[key]["summary"]["cost_model"] == "learned"
    assert recs["measured"] != recs["synthetic"]
    assert recs["measured"]["summary"]["total_cost_usd"] != \
        recs["synthetic"]["summary"]["total_cost_usd"]


def test_the_learned_run_shares_the_model_s_rls():
    """The cost-aware dispatcher shares the learned model's estimator:
    the summary's coefficient and count are that one object's."""
    sc = mod("repro_torch", "scenario")
    model = importlib.import_module("repro_torch.costmodel.model")
    cal = importlib.import_module("repro_torch.costmodel.calibrate")
    cm = model.LearnedCostModel(cal.calibrate(mode="synthetic"))
    scen = _llm(True)("repro_torch").scenario
    res = sc.run(type(scen)(workload=scen.workload, fleet=scen.fleet,
                            policy=scen.policy, resilience=scen.resilience,
                            cost_model=cm))
    s = res.summary()
    assert cm.rls.n_observed == s["cost_obs"] > 0
    assert cm.rls.coeff == s["cost_coeff"]


# -- the schema, the shims and the exports ------------------------------------

def test_the_summary_schema_is_jax_s():
    port, jax = mod("repro_torch", "scenario"), mod("repro", "scenario")
    assert port.SCHEMA_VERSION == jax.SCHEMA_VERSION == 1
    assert port.SUMMARY_KEYS_V1 == jax.SUMMARY_KEYS_V1
    for res in (_azure_single("repro_torch"), _azure_fleet("repro_torch")):
        assert set(port.SUMMARY_KEYS_V1) <= set(res.summary())


def _shims(pkg):
    """Each deprecated entry point beside the Scenario it builds."""
    sc, TraceSpec = _api(pkg)
    tr = mod(pkg, "traces")
    cfg = mod(pkg, "configs").get_config("deepseek-7b")
    gateway = mod(pkg, "serving.gateway")
    tasks = tr.generate_workload(TraceSpec(**SMALL, seed=8)).tasks
    out = {}
    with pytest.warns(DeprecationWarning):
        out["run_policy"] = (
            mod(pkg, "core.simulate").run_policy(
                "hybrid", tasks, n_cores=8, containers="fixed",
                adapt_pct=95.0),
            sc.run(sc.Scenario(
                workload=sc.WorkloadSpec(kind="tasks", tasks=tasks),
                fleet=sc.FleetSpec(cores_per_node=8, containers="fixed"),
                policy=sc.PolicySpec(name="hybrid", adapt_pct=95.0))).raw)
    with pytest.warns(DeprecationWarning):
        out["run_cluster"] = (
            mod(pkg, "cluster").run_cluster(
                tasks, n_nodes=3, cores_per_node=4, dispatcher="affinity",
                containers="fixed", seed=8),
            sc.run(sc.Scenario(
                workload=sc.WorkloadSpec(kind="tasks", tasks=tasks),
                fleet=sc.FleetSpec(n_nodes=3, cores_per_node=4,
                                   dispatcher="affinity",
                                   containers="fixed", seed=8))).raw)
    reqs = gateway.requests_from_trace(cfg, TraceSpec(**SMALL, seed=8))
    serving = sc.ServingSpec(model=cfg)
    with pytest.warns(DeprecationWarning):
        out["run_gateway"] = (
            gateway.run_gateway(cfg, "hybrid", n_slots=12, n_fifo=6,
                                requests=reqs).sim,
            sc.run(sc.Scenario(
                workload=sc.WorkloadSpec(kind="tasks", tasks=reqs),
                fleet=sc.FleetSpec(cores_per_node=12),
                policy=sc.PolicySpec(name="hybrid", adapt_pct=95.0,
                                     rightsize=True, n_fifo=6,
                                     serving=serving))).raw)
    with pytest.warns(DeprecationWarning):
        out["run_gateway_fleet"] = (
            gateway.run_gateway_fleet(cfg, "cfs", n_nodes=2,
                                      slots_per_node=6, requests=reqs),
            sc.run(sc.Scenario(
                workload=sc.WorkloadSpec(kind="tasks", tasks=reqs),
                fleet=sc.FleetSpec(n_nodes=2, cores_per_node=6,
                                   dispatcher="least_loaded"),
                policy=sc.PolicySpec(name="cfs", adapt_pct=95.0,
                                     rightsize=True,
                                     serving=serving))).raw)
    return out


@pytest.mark.parametrize("shim", ["run_policy", "run_cluster", "run_gateway",
                                  "run_gateway_fleet"])
def test_each_shim_equals_its_scenario_and_jax_s(shim):
    port, jax = _shims("repro_torch")[shim], _shims("repro")[shim]
    same_result(*port)
    same_result(port[0], jax[0])


def test_the_lazy_exports_are_jax_s():
    import repro
    import repro_torch
    names = ("run", "Scenario", "ScenarioResult", "WorkloadSpec",
             "FleetSpec", "PolicySpec", "ServingSpec", "ResilienceSpec",
             "SCHEMA_VERSION", "SUMMARY_KEYS_V1", "PricingSpec",
             "CostModel", "StaticCostModel", "LearnedCostModel",
             "make_cost_model", "MonteCarlo", "MonteCarloResult")
    assert set(repro_torch.__all__) == set(names) | {"__version__"}
    assert set(repro_torch.__all__) == set(repro.__all__)
    assert repro_torch.__version__ == repro.__version__
    scenario = importlib.import_module("repro_torch.scenario")
    costmodel = importlib.import_module("repro_torch.costmodel")
    mc = importlib.import_module("repro_torch.mc")
    for name in names:
        src = next(m for m in (scenario, costmodel, mc) if hasattr(m, name))
        assert getattr(repro_torch, name) is getattr(src, name)
        assert name in dir(repro_torch)
    with pytest.raises(AttributeError):
        repro_torch.run_cells        # only the front doors are lazy exports
    core = importlib.import_module("repro_torch.core")
    assert "run_policy" in core.__all__
    serving = importlib.import_module("repro_torch.serving")
    for name in ("GatewayResult", "SlotCFS", "SlotHybridScheduler",
                 "requests_from_trace", "run_gateway", "run_gateway_fleet"):
        assert name in serving.__all__


def test_importing_the_package_loads_no_scenario():
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch; "
         "print(sorted(m for m in sys.modules if m.startswith("
         "('repro_torch.scenario', 'repro_torch.cluster'))))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
