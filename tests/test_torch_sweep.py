"""The port's grid runner ``repro_torch.cluster.sweep`` against the JAX
package's ``repro.cluster.sweep``: ``run_cell`` rows dict for dict on
every axis (containers, llm workload, zoned topology, retry, pricing,
learned cost model), the helpers (``build_grid``, ``shard_grid``,
``merge_rows``, ``_row_key``, ``PRESETS``, ``print_rows``), the CLI's
rows and output, and the batched backend (``backend="torch"`` on the
kernel's plain version) against JAX's scalar rows less ``backend``. Also
``configs.all_cells`` against JAX's.

    pytest -q tests/test_torch_sweep.py
"""
import json
from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

from repro.cluster import sweep as jsweep  # noqa: E402
from repro.configs import all_cells as jax_all_cells  # noqa: E402
from repro_torch.cluster import sweep  # noqa: E402
from repro_torch.configs import all_cells  # noqa: E402

SMALL = dict(cores_per_node=4, minutes=1, invocations_per_min=60.0,
             n_functions=10, seed=0)
CLI_SMALL = ["--cores-per-node", "4", "--minutes", "1",
             "--invocations-per-min", "60", "--n-functions", "10"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain MC version steps through thousands of tiny tensor ops:
    torch's intra-op threads only spin on them beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def strip(row, keys=("backend",)):
    return {k: v for k, v in row.items() if k not in keys}


CELLS = {
    "single_cfs": dict(node_policy="cfs", dispatcher="none", n_nodes=1),
    "histogram_warm_affinity": dict(node_policy="hybrid",
                                    dispatcher="warm_affinity", n_nodes=2,
                                    containers="histogram"),
    "fixed_least_loaded_load2": dict(node_policy="cfs",
                                     dispatcher="least_loaded", n_nodes=2,
                                     containers="fixed", load_scale=2.0),
    "zoned": dict(node_policy="cfs", dispatcher="least_loaded", n_nodes=2,
                  topology="zoned"),
    "retry": dict(node_policy="hybrid", dispatcher="random", n_nodes=2,
                  retry="on"),
    "premium": dict(node_policy="fifo", dispatcher="round_robin",
                    n_nodes=2, pricing="premium"),
    "learned_cost_aware": dict(node_policy="hybrid", dispatcher="cost_aware",
                               n_nodes=2, cost_model="learned"),
    "llm": dict(node_policy="hybrid", dispatcher="none", n_nodes=1,
                workload="llm", invocations_per_min=20.0, n_functions=4),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_run_cell_rows_equal_jax(name):
    kw = {**SMALL, **CELLS[name]}
    got = sweep.run_cell(sweep.Cell(**kw))
    want = jsweep.run_cell(jsweep.Cell(**kw))
    assert got == want
    assert list(got) == list(want)


@pytest.mark.parametrize("kw, match", [
    (dict(topology="zoned", n_nodes=3), "even n_nodes"),
    (dict(topology="ring"), "unknown topology axis"),
    (dict(retry="maybe"), "unknown retry axis"),
])
def test_cell_axis_errors_equal_jax(kw, match):
    kw = {**SMALL, "node_policy": "cfs", "dispatcher": "random",
          "n_nodes": 2, **kw}
    with pytest.raises(ValueError, match=match) as want:
        jsweep.Cell(**kw).to_scenario()
    with pytest.raises(ValueError, match=match) as got:
        sweep.Cell(**kw).to_scenario()
    assert str(got.value) == str(want.value)


def test_build_grid_and_shards_equal_jax():
    args = (("cfs", "hybrid"), ("random", "least_loaded"), [2, 4],
            (1.0, 2.0))
    grid = sweep.build_grid(*args, **SMALL)
    jgrid = jsweep.build_grid(*args, **SMALL)
    assert [asdict(c) for c in grid] == [asdict(c) for c in jgrid]
    assert len(grid) == 16
    for n in (1, 3):
        shards = [sweep.shard_grid(grid, f"{i}/{n}") for i in range(n)]
        assert [[asdict(c) for c in s] for s in shards] == [
            [asdict(c) for c in jsweep.shard_grid(jgrid, f"{i}/{n}")]
            for i in range(n)]
        assert sorted((c for s in shards for c in s),
                      key=grid.index) == grid
    for bad, match in (("x", "wants 'i/n'"), ("3/3", "out of range"),
                       ("0/0", "out of range")):
        with pytest.raises(ValueError, match=match):
            sweep.shard_grid(grid, bad)
        with pytest.raises(ValueError, match=match):
            jsweep.shard_grid(jgrid, bad)


def test_presets_columns_and_row_key_equal_jax():
    assert sweep.PRESETS == jsweep.PRESETS
    assert sweep.SUMMARY_COLS == jsweep.SUMMARY_COLS
    row = sweep.run_cell(sweep.Cell(**{**SMALL, **CELLS["premium"]}))
    assert sweep._row_key(row) == jsweep._row_key(row)
    assert sweep._row_key({}) == jsweep._row_key({})


def test_print_rows_equal_jax(capsys):
    grid = sweep.build_grid(("cfs",), ("none", "round_robin"), [1, 2],
                            **SMALL)
    rows = sweep.run_sweep(grid, parallel=False)
    sweep.print_rows(rows)
    got = capsys.readouterr().out
    jsweep.print_rows(rows)
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == ",".join(sweep.SUMMARY_COLS)
    # single-node rows carry no util_range: an empty last column
    assert got.splitlines()[1].endswith(",")


def test_merge_rows_equal_unsharded_and_jax(tmp_path):
    grid = sweep.build_grid(("fifo", "hybrid"), ("round_robin",), [2],
                            (1.0, 2.0), **SMALL)
    full = sweep.run_sweep(grid, parallel=False)
    paths = []
    for i in range(2):
        rows = sweep.run_sweep(sweep.shard_grid(grid, f"{i}/2"),
                               parallel=False)
        p = tmp_path / f"s{i}.json"
        p.write_text(json.dumps({"meta": {}, "rows": rows}))
        paths.append(str(p))
    merged = sweep.merge_rows(paths[::-1])
    assert merged == jsweep.merge_rows(paths)
    assert merged == sorted(full, key=sweep._row_key)


def _cli_args(out, *extra):
    return ["--nodes", "2", "--policies", "cfs,hybrid", "--dispatchers",
            "round_robin,least_loaded", *CLI_SMALL, "--serial",
            "--out", str(out), *extra]


def test_cli_python_backend_equals_jax(tmp_path, capsys):
    sweep.main(_cli_args(tmp_path / "t.json", "--backend", "python"))
    got_out = capsys.readouterr().out
    jsweep.main(_cli_args(tmp_path / "j.json", "--backend", "python"))
    assert got_out == capsys.readouterr().out
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert len(got["rows"]) == 4


def test_cli_torch_backend_equals_jax_python(tmp_path, capsys):
    """The CLI's default backend batches the round_robin cells; the
    least_loaded cells fall back and say why; every row, less backend
    and the fallback's reason, is JAX's scalar row."""
    sweep.main(_cli_args(tmp_path / "t.json", "--device", "cpu"))
    got_out = capsys.readouterr().out
    jsweep.main(_cli_args(tmp_path / "j.json"))
    assert got_out == capsys.readouterr().out
    got = json.loads((tmp_path / "t.json").read_text())["rows"]
    want = json.loads((tmp_path / "j.json").read_text())["rows"]
    assert [r["backend"] for r in got] == ["torch", "python"] * 2
    assert [r["fallback_reason"] for r in got] \
        == ["none", "fleet_dispatcher"] * 2
    assert [strip(r, ("backend", "fallback_reason")) for r in got] \
        == [strip(r, ("backend", "fallback_reason")) for r in want]


def test_cli_shard_and_merge_equal_jax(tmp_path, capsys):
    for i in range(2):
        sweep.main(_cli_args(tmp_path / f"t{i}.json", "--backend", "python",
                             "--shard", f"{i}/2"))
        jsweep.main(_cli_args(tmp_path / f"j{i}.json", "--backend",
                              "python", "--shard", f"{i}/2"))
    capsys.readouterr()
    sweep.main(["--merge", str(tmp_path / "t0.json"),
                str(tmp_path / "t1.json"), "--out", str(tmp_path / "t.json")])
    got_out = capsys.readouterr().out
    jsweep.main(["--merge", str(tmp_path / "j0.json"),
                 str(tmp_path / "j1.json"), "--out",
                 str(tmp_path / "j.json")])
    assert got_out == capsys.readouterr().out
    assert json.loads((tmp_path / "t.json").read_text())["rows"] \
        == json.loads((tmp_path / "j.json").read_text())["rows"]


@pytest.mark.parametrize("policy", ["fifo", "cfs", "hybrid"])
def test_run_sweep_torch_equals_jax_python(policy):
    """Single nodes and round_robin / random fleets batch (one launch a
    bucket); a container cell falls back with its reason."""
    grid = sweep.build_grid((policy,), ("none", "round_robin", "random"),
                            [1, 3], **SMALL)
    grid = [c for c in grid if (c.dispatcher == "none") == (c.n_nodes == 1)]
    grid.append(sweep.Cell(policy, "random", 2, containers="fixed", **SMALL))
    jgrid = [jsweep.Cell(**asdict(c)) for c in grid]
    got = sweep.run_sweep(grid, parallel=False, backend="torch",
                          device="cpu")
    want = jsweep.run_sweep(jgrid, parallel=False)
    assert [r["backend"] for r in got] == ["torch"] * 3 + ["python"]
    assert got[-1]["fallback_reason"] == "containers"
    assert [strip(r) for r in got[:3]] == [strip(r) for r in want[:3]]
    assert strip(got[-1], ("backend", "fallback_reason")) \
        == strip(want[-1], ("backend", "fallback_reason"))


def test_run_sweep_parallel_spawns_and_equals_serial():
    grid = sweep.build_grid(("cfs", "hybrid"), ("least_loaded",), [2],
                            **SMALL)
    assert sweep.run_sweep(grid, processes=2) \
        == sweep.run_sweep(grid, parallel=False)
    with pytest.raises(ValueError, match="unknown backend"):
        sweep.run_sweep(grid, backend="jax")


def test_all_cells_equal_jax_in_order():
    got = all_cells()
    assert got == jax_all_cells()
    assert len(got) == 40
