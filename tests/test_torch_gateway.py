"""The port's serving gateway (``repro_torch.serving.gateway``) against the
JAX package's (``repro.serving.gateway``), and the fleet pins.

``run_gateway`` for each policy (with and without a container pool, with
a straggler factor) and ``run_gateway_fleet`` are held to JAX's exactly:
every field of the node results, every task's, the summary, the bill and
the re-dispatch count. ``python -m repro_torch.launch.serve --mode
gateway`` prints the same lines as JAX's ``python -m repro.launch.serve``.

``tests/golden/torch_fleet_golden.json`` pins the records of
``repro_torch.launch.fleet``'s static runs (the gateway's default run and
its fleet, the paper's trace on 4 x 50 cores, the cost model's scenario
small, at full size and serving zamba2-1.2b), which ``chip_smoke.py``
holds the card's host to. Every entry is recomputed here through the
port, and through JAX's package too but for ``REGEN_ONLY``'s (the
full-size scenario, ~50 s a package), which JAX's package computes when
the file is regenerated; both must equal the file. Regenerate it from
JAX's package (only for an intended change of a run) with::

    PYTHONPATH=src:tests python tests/test_torch_gateway.py --regen
"""
import contextlib
import importlib
import io
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import mod, plain, same_result  # noqa: E402

PINS = Path(__file__).parent / "golden" / "torch_fleet_golden.json"
SMALL = dict(minutes=1, invocations_per_min=300.0, n_functions=20)
POLICIES = ("fifo", "cfs", "hybrid")


def fleet_module():
    return importlib.import_module("repro_torch.launch.fleet")


def jax_api():
    """JAX's entry points under the names ``launch.fleet`` uses."""
    fleet = fleet_module()
    return type(fleet.port_api())(**{
        name: getattr(importlib.import_module(f"repro.{m}"), name)
        for m, names in fleet.API.items() for name in names})


def pinned_names():
    """The static runs the pin file holds: every case of ``launch.fleet``
    but the golden fleet, which ``engine_golden.json`` holds."""
    return [n for n in fleet_module().CASES if n != "cluster-hybrid-s0"]


def same_gateway(got, want):
    same_result(got.sim, want.sim)
    assert (got.arch, got.policy, got.redispatches) == \
        (want.arch, want.policy, want.redispatches)
    assert plain(got.summary()) == plain(want.summary())
    assert repr(got.cost_usd()) == repr(want.cost_usd())


def _gateway_run(pkg, policy, arch="rwkv6-1.6b", containers=None,
                 **kw):
    gateway = mod(pkg, "serving.gateway")
    cfg = mod(pkg, "configs").get_config(arch)
    TraceSpec = mod(pkg, "traces").TraceSpec
    if containers is not None:
        containers = mod(pkg, "core.containers").ContainerConfig(
            **containers)
    with pytest.warns(DeprecationWarning):
        return gateway.run_gateway(
            cfg, policy, trace=TraceSpec(**SMALL, seed=3),
            containers=containers, **kw)


GATEWAY_CASES = {
    **{p: dict(n_slots=12, n_fifo=6) for p in POLICIES},
    **{f"{p}-containers": dict(n_slots=12, n_fifo=6,
                               containers=dict(keepalive_ms=20_000.0))
       for p in POLICIES},
    **{f"{p}-straggler": dict(n_slots=10, n_fifo=5, straggler_factor=1.5,
                              arch="deepseek-7b")
       for p in POLICIES},
    "hybrid-no-adapt-no-rightsize": dict(n_slots=12, n_fifo=4,
                                         adapt_pct=None, rightsize=False,
                                         seq_len=1024),
}


@pytest.mark.parametrize("case", list(GATEWAY_CASES))
def test_run_gateway_matches_jax(case):
    policy = case.split("-")[0]
    kw = GATEWAY_CASES[case]
    got = _gateway_run("repro_torch", policy, **kw)
    want = _gateway_run("repro", policy, **kw)
    same_gateway(got, want)
    if case in ("cfs", "cfs-containers"):   # rwkv6's slices are short
        assert got.summary()["preemptions"] > 0
    if case == "hybrid-straggler":      # the slot hybrid counts them
        assert got.redispatches > 0


def test_the_slot_schedulers_restrict_the_fast_forward_as_jax_s():
    for pkg in ("repro", "repro_torch"):
        gateway = mod(pkg, "serving.gateway")
        hybrid = mod(pkg, "core.hybrid").HybridScheduler
        cfs = mod(pkg, "core.policies").CFS
        assert gateway.SlotHybridScheduler._ff_solo_only is True
        assert gateway.SlotCFS._ff_solo_only is True
        assert hybrid._ff_solo_only is False and cfs._ff_solo_only is False
    port = mod("repro_torch", "serving.gateway")
    jax = mod("repro", "serving.gateway")
    for pen in (0.0, 10.0, 62.5, 1e4):
        assert port._serving_quanta(pen) == jax._serving_quanta(pen)


def test_an_explicit_request_list_is_copied():
    gateway = mod("repro_torch", "serving.gateway")
    cfg = mod("repro_torch", "configs").get_config("zamba2-1.2b")
    TraceSpec = mod("repro_torch", "traces").TraceSpec
    reqs = gateway.requests_from_trace(cfg, TraceSpec(**SMALL, seed=4))
    before = plain(reqs)
    with pytest.warns(DeprecationWarning):
        a = gateway.run_gateway(cfg, "cfs", requests=reqs, n_slots=8)
    with pytest.warns(DeprecationWarning):
        b = gateway.run_gateway(cfg, "cfs", requests=reqs, n_slots=8)
    assert plain(reqs) == before
    same_gateway(a, b)
    jax = mod("repro", "serving.gateway")
    jcfg = mod("repro", "configs").get_config("zamba2-1.2b")
    jreqs = jax.requests_from_trace(jcfg, mod("repro", "traces").TraceSpec(
        **SMALL, seed=4))
    assert plain(reqs) == plain(jreqs)


def _fleet_run(pkg, **kw):
    gateway = mod(pkg, "serving.gateway")
    cfg = mod(pkg, "configs").get_config("deepseek-7b")
    TraceSpec = mod(pkg, "traces").TraceSpec
    with pytest.warns(DeprecationWarning):
        return gateway.run_gateway_fleet(
            cfg, trace=TraceSpec(**SMALL, seed=5), **kw)


FLEET_CASES = {
    "hybrid-least_loaded": dict(n_nodes=3, slots_per_node=6),
    "cfs-affinity-containers": dict(
        policy="cfs", n_nodes=2, slots_per_node=8, dispatcher="affinity",
        containers={"keepalive_ms": 20_000.0}, seed=2),
    "hybrid-cost_aware-straggler": dict(
        n_nodes=3, slots_per_node=5, dispatcher="cost_aware",
        n_fifo_frac=0.3, straggler_factor=1.5, seed=1),
    "fifo-round_robin": dict(policy="fifo", n_nodes=2, slots_per_node=6,
                             dispatcher="round_robin"),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_run_gateway_fleet_matches_jax(case):
    kw = FLEET_CASES[case]
    got, want = _fleet_run("repro_torch", **kw), _fleet_run("repro", **kw)
    same_result(got, want)
    assert got.redispatches == want.redispatches
    if "straggler" in case:
        assert got.redispatches > 0


def test_serve_gateway_mode_prints_jax_s_rows(monkeypatch):
    """``launch.serve --mode gateway`` against JAX's ``launch.serve``
    (whose default mode is gateway), both driven by ``sys.argv``."""
    # the gateway splits the slots 25 FIFO / the rest fair, so 50 slots
    flags = ["--arch", "zamba2-1.2b", "--minutes", "1", "--rate", "300",
             "--slots", "50"]
    out = {}
    for pkg, argv in (("repro_torch", ["--mode", "gateway", *flags]),
                      ("repro", flags)):
        serve = importlib.import_module(f"{pkg}.launch.serve")
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                pytest.warns(DeprecationWarning):
            serve.main()
        out[pkg] = buf.getvalue()
    assert out["repro_torch"] == out["repro"]
    lines = out["repro_torch"].splitlines()
    assert [json.loads(x)["policy"] for x in lines[:3]] == list(POLICIES)
    assert lines[3].startswith("[serve] zamba2-1.2b: hybrid saves ")
    assert len(lines) == 4


def test_serve_gateway_mode_touches_no_device(monkeypatch):
    """Gateway mode never resolves ``--device``: a device that does not
    exist is not looked at."""
    serve = importlib.import_module("repro_torch.launch.serve")
    monkeypatch.setattr(serve, "resolve_device", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.warns(DeprecationWarning):
        serve.main(["--mode", "gateway", "--device", "no-such-device",
                    "--minutes", "1", "--rate", "120", "--slots", "30"])
    assert "rwkv6-1.6b: hybrid saves" in buf.getvalue()


# -- the pins -----------------------------------------------------------------

@pytest.fixture(scope="module")
def pins():
    return json.loads(PINS.read_text())


def test_the_pin_file_holds_every_static_run(pins):
    assert sorted(pins) == sorted(pinned_names())


# the pins that JAX's package recomputes only in --regen; JAX's package
# and the port meet on the same scenario at small size (llm-small)
REGEN_ONLY = ("llm-full",)


@pytest.mark.parametrize("name", pinned_names())
def test_both_packages_reproduce_the_pin(pins, name):
    fleet = fleet_module()
    want = pins[name]
    assert fleet.run_case(name) == want
    if name not in REGEN_ONLY:
        assert fleet.run_case(name, api=jax_api()) == want


def test_the_gateway_pin_is_jax_s_default_serve_run(pins):
    """The default gateway run's numbers, as ``repro.launch.serve``
    prints them."""
    rows = {p: pins[f"gateway-{p}"]["row"] for p in POLICIES}
    assert {r["n"] for r in rows.values()} == {2909}
    assert rows["fifo"]["cost_usd"] == 0.015525938476758833
    assert (rows["cfs"]["cost_usd"], rows["cfs"]["preemptions"]) == \
        (0.020907581276749573, 4808)
    assert (rows["hybrid"]["cost_usd"], rows["hybrid"]["preemptions"]) == \
        (0.01863379777483017, 2325)
    assert pins["trace-cfs"]["summary"]["n_requests"] == 12643
    assert pins["llm-full"]["summary"]["n_requests"] == 12643
    assert pins["llm-full"]["summary"]["cost_model"] == "static"
    assert pins["llm-transfer"]["summary"]["cost_model"] == "static"


if __name__ == "__main__":
    if "--regen" in sys.argv:
        fleet = fleet_module()
        api = jax_api()
        out = {}
        for name in pinned_names():
            out[name] = fleet.run_case(name, api=api)
            print(name, flush=True)
        PINS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
        print(f"wrote {PINS}")
    else:
        print(__doc__)
