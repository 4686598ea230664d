"""The port's simulator (``repro_torch.core``) against the JAX package's.

Every entry of ``tests/golden/engine_golden.json`` is reproduced by the
port exactly, its record computed as ``tests/test_engine_equivalence.py``
computes it: the single-node ones (fifo, cfs, hybrid and edf at seeds 0-2
with the container pool, the adaptive limit with the rightsizer, and the
ghOSt interference model) through the port's ``execute_policy``, and the
3-node fleet ``cluster-hybrid-s0`` through its ``run_cluster``. The golden
file is read, never written.
The policies with no golden entry (``fifo_preempt``, ``rr``) and the
microVM mode are held against the JAX package on small traces: every
``SimResult`` field and every task's every field equal."""
import json
from dataclasses import fields

import pytest

torch = pytest.importorskip("torch")

from test_engine_equivalence import GOLDEN, _POOL, _record  # noqa: E402

from repro.core import simulate as jax_simulate  # noqa: E402
from repro.core.containers import ContainerConfig as JaxContainerConfig  # noqa: E402
from repro.traces import TraceSpec as JaxTraceSpec  # noqa: E402
from repro.traces import generate_workload as jax_generate  # noqa: E402
from repro_torch.core import (POLICIES, ContainerConfig, SimResult,  # noqa: E402
                              Task, execute_policy, make_scheduler)
from repro_torch.core import simulate  # noqa: E402
from repro_torch.cluster import run_cluster  # noqa: E402
from repro_torch.traces import TraceSpec, generate_workload  # noqa: E402

SEEDS = (0, 1, 2)
GOLDEN_POLICIES = ("fifo", "cfs", "hybrid", "edf")


def _trace(seed: int):
    return generate_workload(TraceSpec(minutes=1, invocations_per_min=300.0,
                                       n_functions=25, seed=seed)).tasks


def _golden_specs():
    """The golden file's entries, run by the port."""
    specs = {}
    for policy in GOLDEN_POLICIES:
        for seed in SEEDS:
            specs[f"{policy}-s{seed}"] = (
                lambda p=policy, s=seed: execute_policy(
                    p, _trace(s), n_cores=8,
                    containers=ContainerConfig(**_POOL), seed=s))
    specs["hybrid-adapt-rightsize-s0"] = lambda: execute_policy(
        "hybrid", _trace(0), n_cores=8, adapt_pct=95.0, rightsize=True,
        trace_util=True)
    specs["cfs-ghost-s0"] = lambda: execute_policy(
        "cfs", _trace(0), n_cores=8, ghost_mode=True)
    specs["cluster-hybrid-s0"] = lambda: run_cluster(
        _trace(0), n_nodes=3, cores_per_node=8, node_policy="hybrid",
        dispatcher="least_loaded", seed=0,
        containers=ContainerConfig(**_POOL))
    return specs


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("name", list(_golden_specs()))
def test_port_reproduces_the_golden_entry(golden, name):
    got = json.loads(json.dumps(_record(name, _golden_specs()[name]())))
    want = golden[name]
    if name == "cfs-s0" and got != want:
        for g, w in zip(got.get("tasks", []), want.get("tasks", [])):
            assert g == w, f"first per-task drift: got {g} want {w}"
    assert got == want


def test_every_single_node_golden_entry_is_covered(golden):
    # every golden entry, the 3-node cluster run included
    assert set(golden) == set(_golden_specs())


TASK_FIELDS = [f.name for f in fields(Task)]
RESULT_FIELDS = [f.name for f in fields(SimResult)]
SMALL = dict(minutes=1, invocations_per_min=240.0, n_functions=20)


def _task_table(tasks):
    return [tuple(repr(getattr(t, f)) for f in TASK_FIELDS)
            for t in sorted(tasks, key=lambda t: t.tid)]


def _same_result(got, want):
    assert got.mc_stats is None       # the batched engine's field only
    for f in RESULT_FIELDS:
        if f == "mc_stats":
            continue
        g, w = getattr(got, f), getattr(want, f)
        if f in ("tasks", "failed"):
            assert _task_table(g) == _task_table(w), f
        else:
            assert g == w, f
    assert got.summary() == want.summary()


CASES = {
    "fifo_preempt": dict(policy="fifo_preempt", n_cores=6),
    "fifo_preempt-quantum": dict(policy="fifo_preempt", n_cores=6,
                                 quantum_ms=40.0),
    "rr": dict(policy="rr", n_cores=6),
    "rr-pool": dict(policy="rr", n_cores=6, pool=True, seed=3),
    "cfs-microvm": dict(policy="cfs", n_cores=6, microvm=True),
    "hybrid-microvm": dict(policy="hybrid", n_cores=6, microvm=True),
    "fifo-microvm-pool": dict(policy="fifo", n_cores=6, microvm=True,
                              pool=True, seed=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_on_small_traces(case):
    kw = dict(CASES[case])
    policy = kw.pop("policy")
    if kw.pop("pool", False):
        mine_kw = dict(kw, containers=ContainerConfig(**_POOL))
        jax_kw = dict(kw, containers=JaxContainerConfig(**_POOL))
    else:
        mine_kw = jax_kw = kw
    spec = dict(SMALL, seed=len(case))
    got = execute_policy(policy, generate_workload(TraceSpec(**spec)).tasks,
                         **mine_kw)
    want = jax_simulate.execute_policy(
        policy, jax_generate(JaxTraceSpec(**spec)).tasks, **jax_kw)
    _same_result(got, want)
    assert got.total_preemptions() + got.total_ctx > 0


def test_microvm_admission_cap_fails_the_rest():
    tasks = generate_workload(TraceSpec(**SMALL, seed=4)).tasks
    admitted, failed = simulate.admit_microvm(
        simulate.apply_microvm_model(tasks), cap=100)
    assert len(admitted) == 100 and len(failed) == len(tasks) - 100
    assert all(t.failed for t in failed)
    assert [t.service for t in admitted[:5]] == [
        t.service * 1.1 + simulate.MICROVM_BOOT_MS
        for t in sorted(tasks, key=lambda x: x.arrival)[:5]]


def test_policies_and_scheduler_factory():
    assert sorted(POLICIES) == sorted(jax_simulate.POLICIES)
    assert type(make_scheduler("edf", n_cores=2)).__name__ == "EDF"
    with pytest.raises(KeyError):
        make_scheduler("lottery", n_cores=2)
    # run_policy is the deprecated shim over repro_torch.run
    tasks = generate_workload(TraceSpec(**SMALL, seed=5)).tasks
    with pytest.warns(DeprecationWarning):
        shim = simulate.run_policy("fifo", tasks, n_cores=4)
    _same_result(shim, execute_policy("fifo", tasks, n_cores=4))
