"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports jax or anything of the JAX package, and its entry points run on
the card unless the CPU is asked for."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_importing_every_port_module_loads_no_jax_or_repro():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 15
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_source_names_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {m}"


DRY_RUN = """
import sys
from repro_torch.launch import dryrun, mesh
from repro_torch.distributed import sharding, elastic
from repro_torch.kernels import costs
res = dryrun.run_cell("rwkv6-1.6b", "train_4k", layers=1, batch=1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(res["status"], bad)
"""


def test_dry_run_modules_load_no_jax_or_repro():
    """The dry run, the mesh, the sharding resolver, ElasticRunner and the
    kernels' cost formulas stand alone, also while a cell runs."""
    res = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok []"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", ["ServingEngine", "LM", "init_params",
                                   "run_grid", "run_cells"])
def test_default_device_raises_without_cuda(entry):
    _no_card()
    import numpy as np
    from repro_torch.configs import get_smoke
    from repro_torch.core.events import Task
    from repro_torch.mc import Cell, run_cells, run_grid
    from repro_torch.models import LM
    from repro_torch.params import init_params
    from repro_torch.serving import ServingEngine
    cfg = get_smoke("deepseek-7b")
    tasks = [Task(tid=i, arrival=float(i), service=5.0) for i in range(3)]
    calls = {
        "ServingEngine": lambda: ServingEngine(
            cfg, init_params(cfg, device="cpu")),
        "LM": lambda: LM(cfg),
        "init_params": lambda: init_params(cfg),
        "run_grid": lambda: run_grid(
            np.zeros((1, 4)), np.ones((1, 4)), np.array([4], np.int32),
            np.array([0], np.int32), np.array([np.inf]), n_cores=2),
        "run_cells": lambda: run_cells([Cell("cfs", 2, tasks)]),
    }
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        calls[entry]()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
