"""Whole runs of the harness on the CPU at the smoke widths: a mix and a
metric added as new files only are picked up; a run loads no JAX module;
the check comes out false under each fault the cells can have."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from cardbench.faults import (altered_token, limit_frozen, state_unchanged,
                              wrong_lane)
from cardbench.harness import ROOT, load_cell, run_cell
from conftest import smoke_port

RUN = ("deepseek-7b.conv.closed", "granite-moe-3b-a800m.conv.closed")


def cpu_run(cell, seed=2**31 + 9, seconds=4.0, trace=False, faults=None,
            **port):
    return run_cell(cell, seed, seconds, trace, device="cpu",
                    port=dict(smoke_port(cell), **port), faults=faults)


@pytest.mark.parametrize("name", RUN)
def test_a_sound_run_is_correct(name):
    out = cpu_run(load_cell(name, ROOT))
    assert out["correct"], out["checks"]
    cell = load_cell(name, ROOT)
    for number in cell.config["limits"]:
        assert out["checks"][number]["tokens"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"


def test_new_mix_and_metric_files_are_picked_up(tmp_path):
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "cardbench/traffic/conv_closed.json")
                     .read_text())
    mix["arrivals"] = {"kind": "closed", "clients": 3}
    (tmp_path / "cardbench/traffic/dummy_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "cardbench/metrics/dummy_requests.py").write_text(
        "def read(rec):\n    return float(len(rec.reqs))\n")
    bench["workloads"].append({"name": "deepseek-7b.dummy",
                               "config": "deepseek-7b",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test's"})
    bench["end_to_end"].append({"name": "dummy_requests", "unit": "req",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["deepseek-7b.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = cpu_run(load_cell("deepseek-7b.dummy", tmp_path))
    assert out["metrics"]["dummy_requests"]["value"] >= 3
    assert "dummy_requests" not in cpu_run(
        load_cell("deepseek-7b.conv.closed", tmp_path))["metrics"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "cardbench"))
    import run
    monkeypatch.setitem(sys.modules, "repro_torchlike", object())
    monkeypatch.setitem(sys.modules, "jaxley.x", object())
    found = run.forbidden_modules()
    assert "repro_torchlike" not in found and "jaxley.x" not in found
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in run.forbidden_modules()


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from cardbench.harness import ROOT, load_cell, run_cell\n"
        "from conftest import smoke_port\n"
        "import run\n"
        "cell = load_cell('granite-moe-3b-a800m.conv.closed', ROOT)\n"
        "run_cell(cell, 5, 1.5, True, device='cpu', port=smoke_port(cell))\n"
        "print('LOADED', run.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"), str(ROOT / "cardbench/tests"))
    code = code.replace("import run", "sys.path.insert(0, %r); import run"
                        % str(ROOT / "cardbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
    assert "repro_torch" in subprocess.run(
        [sys.executable, "-c", code.replace(
            "run.forbidden_modules()",
            "sorted(m for m in sys.modules if m.startswith('repro'))")],
        capture_output=True, text=True, timeout=600).stdout


# -- faults: each must turn ``correct`` false ------------------------------------

#: the limits of the number the cells compare, the widest of the sampled
#: requests' mean gaps, at the smoke widths (a vocabulary of 8192, so that
#: the best logits lie as close as the cells' do) on the CPU, seeds
#: 2**31 + 9, 11, 12, 13: sound runs read 0-0.00013 (deepseek-7b) and
#: 0-0.00098 (granite; bf16 against the float32 reference), the control
#: 0.36-0.51 and 0.34-0.73, a decode step that leaves the cache unchanged
#: 0.018-0.197 and 0.0064-0.022, a state restored into the wrong lane
#: 0.33-0.53 and 0.17-0.66
SMOKE_VOCAB = 8192
SMOKE_LIMITS = {RUN[0]: {"logit_gap_req_mean": 0.005},
                RUN[1]: {"logit_gap_req_mean": 0.003}}


@pytest.mark.parametrize("name", RUN)
@pytest.mark.parametrize("fault,check", [
    (altered_token, "logit_gap_req_mean"),
    (state_unchanged, "logit_gap_req_mean"),
    (wrong_lane, "logit_gap_req_mean"),
    (limit_frozen, "sched_mismatch")])
def test_a_fault_is_not_correct(name, fault, check):
    cell = load_cell(name, ROOT)
    cell.config["limits"] = dict(SMOKE_LIMITS[name])
    # a window long enough that some hundreds of tokens finish on a busy CPU
    sound = cpu_run(cell, seconds=10.0, vocab=SMOKE_VOCAB)
    assert sound["correct"], sound["checks"]
    out = cpu_run(cell, seconds=10.0, faults=fault, vocab=SMOKE_VOCAB)
    c = out["checks"][check]
    assert not out["correct"] and c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("name", RUN)
def test_the_control_is_not_correct(name):
    """The reference in float8 in the program's place reads far above what
    the program reads, and above the smoke limit (the chip's run of the
    same: ``cardbench/control.py`` at the cell's size)."""
    from cardbench import control
    from conftest import smoke_port as sp
    cell = load_cell(name, ROOT)
    out, _ = control.readings(cell, 2**31 + 3, 5.0, True, device="cpu",
                              port=dict(sp(cell), vocab=SMOKE_VOCAB))
    assert out["tokens"] > 100
    limit = SMOKE_LIMITS[name]["logit_gap_req_mean"]
    assert out["program"]["logit_gap_req_mean"] < limit \
        < out["control"]["logit_gap_req_mean"], out
    assert 10 * out["program"]["logit_gap_mean"] \
        < out["control"]["logit_gap_mean"], out
