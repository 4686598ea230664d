"""The port's surface covers the JAX package's: every module of
``src/repro/`` has a counterpart in ``src/repro_torch/`` of the same
dotted name, and every public name of a JAX module (its ``__all__``, or
else each function and class it defines) exists in the counterpart, a
submodule for a submodule. The exceptions are listed below, each with
its reason (ROADMAP.md §1 "Not ported, by design") and, where the port
has one under another name, the counterpart, which must exist.

Every parameter of a JAX public function or class (its ``__init__``)
exists in the counterpart's signature too, or is listed in RENAMED with
the port's name for it (which must exist) or None, and the reason: the
port's idiom (a ``torch.Generator`` for a key, a process group for an
axis name, a tensor for a one-entry state dict) or a design difference.

    pytest -q tests/test_torch_surface.py
"""
import importlib
import inspect
import os
import types
from pathlib import Path
from typing import Optional

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "src" / "repro"

NO_MODULE = {
    "repro.kernels.ref": ("repro_torch.kernels.plain",
                          "the JAX oracle; the port's plain versions"),
    "repro.distributed.params": ("repro_torch.params",
                                 "materialize, the weights' source; the "
                                 "port's params.py"),
    "repro.launch.hlo_analysis": ("repro_torch.kernels.costs",
                                  "parses XLA's HLO text; the kernels' "
                                  "recorded bytes and flops instead"),
}

_SPECS = "makes parameter specs; the port's live in params.py"
_PARAMS = "of distributed.params, not ported; the port's params.py"
_WRAPPER = "a kernel wrapper; the port's dispatches by device"

NO_NAME = {
    ("repro.costmodel.features", "compile_kernel"): (
        "repro_torch.costmodel.features.kernel_features",
        "XLA's compile of a kernel; the port reads its rows on the meta "
        "device"),
    ("repro.mc.dispatch", "enable_compile_cache"): (
        "repro_torch.kernels.build.build",
        "XLA's persistent compile cache; the kernels are built once into "
        "build/repro_torch/"),
    ("repro.mc.dispatch", "compile_cache_entries"): (
        "repro_torch.kernels.build.build", "the same cache's entry count"),
    ("repro.mc.kernels", "make_cell_kernel"): (
        "repro_torch.kernels.mc_cell.mc_cell_cuda",
        "the jitted vmap(while_loop) factory; the CUDA kernel's wrapper"),
    ("repro.mc.kernels", "grid_kernel"): (
        "repro_torch.kernels.mc_cell.run_grid_plain",
        "the cached jitted grid; the plain version"),
    ("repro.launch.mesh", "make_production_mesh"): (
        "repro_torch.launch.mesh.mesh_preset", "the TPU pod meshes"),
    ("repro.launch.mesh", "make_debug_mesh"): (
        "repro_torch.launch.mesh.make_mesh", "a jax.sharding.Mesh"),
    ("repro.distributed", "ParamSpec"): ("repro_torch.params.Leaf", _PARAMS),
    ("repro.distributed", "abstract_params"): (
        "repro_torch.params.param_specs", _PARAMS),
    ("repro.distributed", "count_params"): (
        "repro_torch.params.count_params", _PARAMS),
    ("repro.distributed", "is_spec"): (None, _PARAMS),
    ("repro.distributed", "materialize"): (
        "repro_torch.params.init_params", _PARAMS),
    ("repro.distributed", "param_shardings"): (
        "repro_torch.params.param_specs_pspec", _PARAMS),
    ("repro.distributed", "param_specs_pspec"): (
        "repro_torch.params.param_specs_pspec", _PARAMS),
    ("repro.distributed", "tree_map_specs"): (None, _PARAMS),
    ("repro.kernels", "ref"): ("repro_torch.kernels.plain",
                               "the JAX oracle; the port's plain versions"),
    ("repro.kernels", "gqa_flash_attention"): (
        "repro_torch.kernels.ops.flash_attention",
        "only repeats K/V; the port's kernels take GQA natively"),
    ("repro.kernels.ops", "gqa_flash_attention"): (
        "repro_torch.kernels.ops.flash_attention",
        "only repeats K/V; the port's kernels take GQA natively"),
    ("repro.models", "bf16"): ("repro_torch.models.layers.mm",
                               "a cast to the compute dtype; the port "
                               "casts f32 masters on use"),
    ("repro.models.layers", "bf16"): ("repro_torch.models.layers.mm",
                                      "the same cast"),
    ("repro.models.layers", "set_compute_dtype"): (
        "repro_torch.models.LM",
        "a global compute dtype; the port's LM takes its dtype"),
    ("repro.models", "flash_attention_xla"): (
        "repro_torch.kernels.flash_attention.flash_attention_plain",
        "JAX's XLA attention; the models call the kernels"),
    ("repro.models.layers", "flash_attention_xla"): (
        "repro_torch.kernels.flash_attention.flash_attention_plain",
        "the same"),
    ("repro.models", "attend_cache"): (
        "repro_torch.kernels.decode_attention.decode_attention_plain",
        "JAX's XLA decode attention; the models call the kernels"),
    ("repro.models.layers", "attend_cache"): (
        "repro_torch.kernels.decode_attention.decode_attention_plain",
        "the same"),
}
for _mod in ("repro.models", "repro.models.layers"):
    for _n in ("attn_specs", "mlp_specs", "moe_specs"):
        NO_NAME[_mod, _n] = ("repro_torch.params.param_specs", _SPECS)
for _mod, _n in (("repro.models", "ssm_specs"), ("repro.models.ssm",
                                                  "ssm_specs"),
                 ("repro.models", "rwkv_specs"), ("repro.models.rwkv",
                                                   "rwkv_specs"),
                 ("repro.models", "model_specs"),
                 ("repro.models.transformer", "model_specs")):
    NO_NAME[_mod, _n] = ("repro_torch.params.param_specs", _SPECS)
for _n in ("decode_attention", "flash_attention", "fused_rmsnorm",
           "rwkv6_scan", "ssm_scan"):
    NO_NAME["repro.kernels", _n] = (f"repro_torch.kernels.ops.{_n}",
                                    _WRAPPER)
    NO_NAME[f"repro.kernels.{_n}", _n] = (f"repro_torch.kernels.ops.{_n}",
                                          _WRAPPER)


#: (public name, JAX parameter) -> (the port's parameter or None, reason)
RENAMED = {
    ("MonteCarlo", "compile_cache_dir"): (
        None, "XLA's persistent compile cache; the kernels are built once "
        "into build/repro_torch/"),
    ("compressed_tree_allreduce", "psum_axis"): (
        "group", "a JAX mesh axis name; a torch.distributed process group"),
    ("cell_params", "sc"): (
        "policy", "a Scenario; the port takes its policy, cores and "
        "keywords (policy, n_cores, kw)"),
    ("attention", "write_pos"): (
        None, "the slot a ring's decode writes; the port's rings hold "
        "position p at slot p % W, found from cache_pos"),
    ("attention", "key_positions"): (
        None, "a ring's slot-to-position map; the port's ring layout "
        "needs none"),
    ("ssm_block", "state"): ("h", "the state dict {'h'}; its tensor"),
    ("ssm_decode", "state"): ("h", "the state dict {'h'}; its tensor"),
    ("rwkv_channel_mix", "state"): (
        "x_cm", "the state dict; its one row the channel mix reads"),
    ("vision_patch_embeds", "key"): (
        "generator", "a jax.random key; a torch.Generator"),
    ("input_embeds_for", "key"): (
        "generator", "a jax.random key; a torch.Generator"),
    ("encodec_token_embeds", "params_embed"): (
        "embed", "the token embedding table under the port's name"),
    ("global_norm", "tree"): (
        "grads", "a pytree; the gradients by name, summed in leaf_order's "
        "order"),
}


def parameters(obj) -> Optional[list[str]]:
    """The named parameters of a function or of a class's constructor
    (not ``*args`` / ``**kwargs``), or None where Python shows no
    signature."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [n for n, p in sig.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def signature_pairs(name: str):
    """(public name, JAX parameters, port parameters) of each function and
    class of the JAX module ``name`` that has a counterpart."""
    if name in NO_MODULE:
        return
    jmod = import_jax(name)
    tmod = importlib.import_module(counterpart(name))
    for n in public_names(jmod):
        jo = getattr(jmod, n)
        if (name, n) in NO_NAME or isinstance(jo, types.ModuleType) \
                or not callable(jo):
            continue
        jp, tp = parameters(jo), parameters(getattr(tmod, n))
        if jp is not None and tp is not None:
            yield n, jp, tp


def jax_modules() -> list[str]:
    """Every module of src/repro/ by its file (launch/ is a namespace
    package, which pkgutil does not walk)."""
    out = []
    for p in sorted(JAX_SRC.rglob("*.py")):
        parts = list(p.relative_to(JAX_SRC.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def public_names(mod) -> list[str]:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, o in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(o)
                                          or inspect.isclass(o))
            and o.__module__ == mod.__name__]


def import_jax(name: str):
    """Import a JAX module, undoing the one import-time side effect in the
    package (``launch/dryrun.py`` sets XLA_FLAGS to 512 host devices, which
    would reach every later JAX test in this process)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def resolve(path: str):
    """A dotted path to a module or to an attribute of one."""
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError:
        mod, _, attr = path.rpartition(".")
        return getattr(importlib.import_module(mod), attr)


def counterpart(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


MODULES = jax_modules()


def test_walk_finds_the_whole_package():
    assert len(MODULES) > 80
    assert "repro.launch.hlo_analysis" in MODULES
    assert "repro.cluster.sweep" in MODULES
    assert "repro.mc.montecarlo" in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_has_its_counterpart(name):
    if name in NO_MODULE:
        target, reason = NO_MODULE[name]
        assert reason
        resolve(target)
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(counterpart(name))
        return
    jmod = import_jax(name)
    tmod = importlib.import_module(counterpart(name))
    for n in public_names(jmod):
        if (name, n) in NO_NAME:
            continue
        assert hasattr(tmod, n), f"{counterpart(name)} lacks {n}"
        assert isinstance(getattr(jmod, n), types.ModuleType) \
            == isinstance(getattr(tmod, n), types.ModuleType), \
            f"{counterpart(name)}.{n} is not the same kind of object"


@pytest.mark.parametrize("key", sorted(NO_NAME), ids="{0[0]}:{0[1]}".format)
def test_exception_is_still_needed_and_has_its_counterpart(key):
    """Each listed name is public in JAX's module and missing (or of
    another kind) in the port's; its counterpart exists."""
    mod, n = key
    target, reason = NO_NAME[key]
    assert reason
    jmod = import_jax(mod)
    assert n in public_names(jmod)
    tmod = importlib.import_module(counterpart(mod))
    if hasattr(tmod, n):
        assert isinstance(getattr(tmod, n), types.ModuleType) \
            != isinstance(getattr(jmod, n), types.ModuleType)
    if target is not None:
        resolve(target)


@pytest.mark.parametrize("name", MODULES)
def test_parameters_have_their_counterparts(name):
    """Each parameter of each JAX public function or class of the module
    is a parameter of the port's counterpart, or RENAMED lists it (with
    the port's name for it, which the counterpart takes)."""
    for n, jp, tp in signature_pairs(name):
        for p in jp:
            if p in tp:
                continue
            assert (n, p) in RENAMED, \
                f"{counterpart(name)}.{n} takes no parameter {p!r} " \
                f"(JAX's {name}.{n} does): port it or list it in RENAMED"
            port, reason = RENAMED[n, p]
            assert reason and (port is None or port in tp), (n, p, tp)


@pytest.mark.parametrize("key", sorted(RENAMED), ids="{0[0]}:{0[1]}".format)
def test_renamed_parameter_is_still_renamed(key):
    """Each RENAMED entry names a JAX parameter that some counterpart
    still lacks."""
    n, p = key
    assert any(name == n and p in jp and p not in tp
               for mod in MODULES for name, jp, tp in signature_pairs(mod))
