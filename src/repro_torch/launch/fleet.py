"""The fleet simulator's pinned runs: each run's exact record, and the
cost model's static-against-learned comparison on a fleet.

The runs (``CASES``):

* ``cluster-hybrid-s0`` — the golden 3-node fleet: 3 nodes x 8 cores,
  hybrid, ``least_loaded``, seed 0, the fixed container pool ``POOL``,
  through ``run_cluster``; its record is the golden file's
  (``golden_record``).
* ``gateway-<policy>`` — the serving gateway's default run: rwkv6-1.6b,
  1 minute at 3,000 requests a minute, 50 slots, fifo / cfs / hybrid,
  through ``run_gateway``; ``gateway-fleet`` the same requests through
  ``run_gateway_fleet`` on 4 nodes x 16 slots, ``least_loaded``.
* ``trace-<policy>`` — the paper's default trace (2 minutes, 12,643
  invocations) on 4 nodes x 50 cores, ``least_loaded``, seed 0.
* ``llm-small`` / ``llm-full`` — the cost model's scenario: deepseek-7b
  as an ``llm`` workload, ``cost_aware`` dispatch, hybrid, admission
  ``max_load="auto"`` with overload queued; small is 1 minute at 120 a
  minute over 8 functions (seed 11) on 2 x 4 cores (seed 3), full the
  default trace on 4 x 50 cores (seed 0). ``artifact=None`` runs it with
  the static cost model; a calibration artifact dict runs it learned.
  deepseek-7b is the calibration's reference model, so a learned run
  bills its spec's anchored token costs whatever the artifact's weights.
* ``llm-transfer`` — the small scenario with zamba2-1.2b served: a
  learned run prices its tokens by the fit's ratios against the
  reference, so the artifact's weights reach the bill.

Every record holds the run's summary, its exact costs and counts, and a
SHA-256 digest of every task's completion, first run, preemptions,
context switches and migrations (and of the fleet's task-to-node
assignments), so two records are equal only if the runs agree bit for
bit. ``run_case(name, artifact, api)`` takes the entry points from
``api`` (``port_api()`` by default): a namespace holding the names of
``API``, so the same cases can be run through another package of the
same interface. ``timed_cell(cell)`` runs one grid cell of
``cluster.sweep`` on the scalar engine, the rows the batched sweep is
held to. Host simulation only: nothing here touches a device.
"""
from __future__ import annotations

import hashlib
import importlib
import json
import time
import warnings
from types import SimpleNamespace
from typing import Optional

# module (under the package root) -> the entry points the cases use
API = {
    "scenario": ("Scenario", "WorkloadSpec", "FleetSpec", "PolicySpec",
                 "ResilienceSpec", "run"),
    "traces": ("TraceSpec", "generate_workload"),
    "configs": ("get_config",),
    "core.containers": ("ContainerConfig",),
    "cluster.sim": ("run_cluster",),
    "serving.llm": ("LLMSpec",),
    "serving.gateway": ("requests_from_trace", "run_gateway",
                        "run_gateway_fleet"),
}

# the golden fleet's fixed container pool
POOL = dict(policy="fixed", capacity_mb=1536.0, keepalive_ms=8_000.0,
            sweep_ms=1_000.0)
GATEWAY_ARCH, GATEWAY_SLOTS = "rwkv6-1.6b", 50
GATEWAY_TRACE = dict(minutes=1, invocations_per_min=3000.0)
COST_ARCH = "deepseek-7b"        # the calibration's reference model
TRANSFER_ARCH = "zamba2-1.2b"    # priced by the fit's ratios when learned
LLM = {"small": (dict(minutes=1, invocations_per_min=120.0, n_functions=8,
                      seed=11), 2, 4, 3),
       "full": ({}, 4, 50, 0)}          # (trace, nodes, cores, fleet seed)
POLICIES = ("fifo", "cfs", "hybrid")
GATEWAY_ROW = ("policy", "n", "p99_execution_s", "p99_response_s",
               "p99_turnaround_s", "cost_usd", "preemptions")


def port_api() -> SimpleNamespace:
    root = __package__.split(".")[0]
    return SimpleNamespace(**{
        name: getattr(importlib.import_module(f"{root}.{mod}"), name)
        for mod, names in API.items() for name in names})


# -- records ------------------------------------------------------------------

def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _task_digest(tasks) -> str:
    return _digest(";".join(
        f"{t.tid}:{t.completion!r}:{t.preemptions}:{t.ctx_switches}:"
        f"{t.first_run!r}:{t.migrations}"
        for t in sorted(tasks, key=lambda x: x.tid)))


def sim_record(res) -> dict:
    """Exact observable state of one node's run (the golden file's)."""
    rec = {
        "n": len(res.tasks),
        "failed": len(res.failed),
        "task_digest": _task_digest(res.tasks),
        "total_ctx": res.total_ctx,
        "preemptions": res.total_preemptions(),
        "makespan": res.makespan(),
        "cost_usd": res.cost_usd(),
        "init_cost_usd": res.init_cost_usd(),
        "warm_hold_usd": res.warm_hold_usd(),
        "cold_starts": res.cold_starts(),
    }
    if res.container_stats is not None:
        cs = res.container_stats
        rec["pool"] = {k: cs[k] for k in
                       ("warm_hits", "cold_starts", "evictions_ttl",
                        "evictions_capacity", "warm_mb_ms", "idle_mb")}
    if res.migrations is not None:
        rec["core_migrations"] = res.migrations
    return rec


def golden_record(res) -> dict:
    """A fleet's record as the golden file keeps it."""
    return {
        "assignments_digest": _digest(";".join(
            f"{tid}:{nid}" for tid, nid in res.assignments)),
        "nodes": [sim_record(r) for r in res.node_results],
        "cost_usd": res.cost_usd(),
    }


def _jsonable(rec: dict) -> dict:
    """The record as a JSON file gives it back (floats round-trip)."""
    return json.loads(json.dumps(rec))


# -- the cases ----------------------------------------------------------------

def _golden_fleet(api, artifact):
    tasks = api.generate_workload(api.TraceSpec(
        minutes=1, invocations_per_min=300.0, n_functions=25, seed=0)).tasks
    res = api.run_cluster(
        tasks, n_nodes=3, cores_per_node=8, node_policy="hybrid",
        dispatcher="least_loaded", seed=0,
        containers=api.ContainerConfig(**POOL))
    return golden_record(res)


def _gateway_requests(api):
    cfg = api.get_config(GATEWAY_ARCH)
    return cfg, api.requests_from_trace(cfg, api.TraceSpec(**GATEWAY_TRACE))


def _gateway(policy):
    def case(api, artifact):
        cfg, reqs = _gateway_requests(api)
        r = api.run_gateway(cfg, policy, requests=reqs,
                            n_slots=GATEWAY_SLOTS)
        s = r.summary()
        return {"row": {k: s[k] for k in GATEWAY_ROW}, "summary": s,
                "record": sim_record(r.sim)}
    return case


def _gateway_fleet(api, artifact):
    cfg, reqs = _gateway_requests(api)
    res = api.run_gateway_fleet(cfg, "hybrid", n_nodes=4, slots_per_node=16,
                                dispatcher="least_loaded", requests=reqs)
    return {"summary": res.summary(), "record": golden_record(res)}


def _scenario_record(res) -> dict:
    return {"summary": res.summary(), "record": golden_record(res.raw)}


def _trace(policy):
    def case(api, artifact):
        res = api.run(api.Scenario(
            workload=api.WorkloadSpec(kind="azure", trace=api.TraceSpec()),
            fleet=api.FleetSpec(n_nodes=4, cores_per_node=50,
                                dispatcher="least_loaded", seed=0),
            policy=api.PolicySpec(name=policy)))
        return _scenario_record(res)
    return case


def llm_scenario(api, size: str, cost_model=None, arch: str = COST_ARCH):
    """The cost model's fleet scenario at ``size`` (small / full),
    serving ``arch``."""
    trace, n_nodes, cores, seed = LLM[size]
    return api.Scenario(
        workload=api.WorkloadSpec(kind="llm", trace=api.TraceSpec(**trace),
                                  llm=api.LLMSpec(model=arch)),
        fleet=api.FleetSpec(n_nodes=n_nodes, cores_per_node=cores,
                            dispatcher="cost_aware", seed=seed),
        policy=api.PolicySpec(name="hybrid"),
        resilience=api.ResilienceSpec(
            admission={"max_load": "auto", "overload_action": "queue"}),
        cost_model=cost_model)


def _llm(size, arch=COST_ARCH):
    def case(api, artifact):
        cm = dict(artifact) if artifact is not None else None
        return _scenario_record(api.run(llm_scenario(api, size, cm, arch)))
    return case


CASES = {
    "cluster-hybrid-s0": _golden_fleet,
    **{f"gateway-{p}": _gateway(p) for p in POLICIES},
    "gateway-fleet": _gateway_fleet,
    **{f"trace-{p}": _trace(p) for p in POLICIES},
    "llm-small": _llm("small"),
    "llm-full": _llm("full"),
    "llm-transfer": _llm("small", TRANSFER_ARCH),
}
# the cases a calibration artifact changes -> the model each serves
LEARNED = {"llm-small": COST_ARCH, "llm-full": COST_ARCH,
           "llm-transfer": TRANSFER_ARCH}


def run_case(name: str, artifact: Optional[dict] = None,
             api: Optional[SimpleNamespace] = None) -> dict:
    """One case's record, as a JSON file gives it back. ``artifact``
    (a calibration artifact dict) runs a ``LEARNED`` case with the
    learned cost model; ``None`` runs it static."""
    if artifact is not None and name not in LEARNED:
        raise ValueError(f"{name} takes no cost model")
    with warnings.catch_warnings():
        # the cases go through the deprecated shims on purpose
        warnings.simplefilter("ignore", DeprecationWarning)
        return _jsonable(CASES[name](api or port_api(), artifact))


def timed_case(name: str, artifact: Optional[dict] = None) -> tuple:
    """``(record, host seconds)`` of one case through the port; a
    process pool's worker."""
    t0 = time.perf_counter()
    rec = run_case(name, artifact)
    return rec, time.perf_counter() - t0


def timed_cell(cell) -> tuple:
    """``(row, host seconds)`` of one ``cluster.sweep.Cell`` run on the
    scalar engine (``run_cell``); a process pool's worker."""
    from ..cluster.sweep import run_cell
    t0 = time.perf_counter()
    row = run_cell(cell)
    return row, time.perf_counter() - t0
