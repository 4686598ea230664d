"""The port's sharding resolver, parameter axes and ElasticRunner held
against the JAX package's (``repro.distributed``), on the CPU.

Specs are resolved against stub contexts that carry only axis sizes and
the rules, as ``tests/test_sharding.py`` builds them, so no mesh of
devices is needed: JAX's TPU meshes (16 x 16, 2 x 16 x 16) and the
port's (1 x 4, 2 x 2, 1 x 1). A JAX ``PartitionSpec`` is a tuple, so it
compares entry for entry with the port's spec.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as japplicable
from repro.distributed import resolve_spec as jresolve
from repro.distributed.elastic import ElasticRunner as JElasticRunner
from repro.distributed.params import is_spec
from repro.distributed.sharding import DEFAULT_RULES as JRULES
from repro.models import cache_specs as jcache_specs
from repro.models import model_specs
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.distributed import ElasticRunner, Mesh, viable_meshes
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingCtx,
                                              resolve_spec, spec_shards,
                                              use_mesh)
from repro_torch.launch.mesh import MESHES, make_mesh, mesh_preset
from repro_torch.models import cache_specs
from repro_torch.params import jax_leaves, param_specs, param_specs_pspec

MESH_SIZES = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16},
              "1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2},
              "1x1": {"data": 1, "model": 1}}


class Ctx:
    """A stub context: axis sizes and the rules, no devices."""

    def __init__(self, sizes, rules):
        self.sizes = sizes
        self.rules = dict(rules)
        self.mesh = type("M", (), {"axis_names": tuple(sizes)})()

    def axis_size(self, name):
        return self.sizes[name]


def ctxs(mesh):
    """(JAX's stub, the port's stub) over one mesh's sizes."""
    return Ctx(MESH_SIZES[mesh], JRULES), Ctx(MESH_SIZES[mesh], DEFAULT_RULES)


def flat_specs(tree, path=()):
    """{path: ParamSpec} of a JAX spec tree."""
    if is_spec(tree):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat_specs(v, path + (k,)))
    return out


def test_rules_and_priorities_are_jax_s():
    from repro.distributed.sharding import RESOLVE_PRIORITY as JPRIO
    from repro_torch.distributed.sharding import RESOLVE_PRIORITY
    assert DEFAULT_RULES == JRULES
    assert RESOLVE_PRIORITY == JPRIO


@pytest.mark.parametrize("mesh", list(MESH_SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_param_leaf_resolves_as_in_jax(arch, mesh):
    """Each leaf of JAX's ``model_specs``: the port's axes are JAX's and
    its resolved spec is JAX's, on the stacked leaf; a port parameter (one
    layer's slice) resolves to JAX's spec past the stacked entries."""
    jctx, pctx = ctxs(mesh)
    jleaves = flat_specs(model_specs(jget_config(arch)))
    leaves = jax_leaves(get_config(arch))
    assert set(leaves) == set(jleaves)
    pspecs = param_specs_pspec(get_config(arch), pctx)
    for path, leaf in leaves.items():
        js = jleaves[path]
        assert leaf.shape == js.shape and leaf.axes == js.axes, path
        want = jresolve(js.shape, js.axes, jctx)
        assert resolve_spec(leaf.shape, leaf.axes, pctx) == tuple(want), path
        assert all(e is None for e in tuple(want)[:leaf.stacked]), path
        for name in leaf.names:
            assert pspecs[name] == tuple(want)[leaf.stacked:], name


@pytest.mark.parametrize("mesh", list(MESH_SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_cache_leaf_resolves_as_in_jax(arch, mesh):
    """Each leaf of JAX's ``cache_specs`` at every applicable shape
    resolves alike in both packages, and each of the port's cache leaves
    (its own layout: the layer axes of JAX's leaves merged into one)
    resolves to the spec of the JAX leaves it holds, past the layer
    axes."""
    jctx, pctx = ctxs(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        B, S = shape.global_batch, shape.seq_len
        tails = {}
        for path, js in flat_specs(jcache_specs(jcfg, B, S)).items():
            want = tuple(jresolve(js.shape, js.axes, jctx))
            assert resolve_spec(js.shape, js.axes, pctx) == want, path
            lead = js.axes.index("batch")        # the layer axes before it
            key = {"tail_h": "ssm_h"}.get(path[-1], path[-1])
            tails.setdefault(key, set()).add((js.shape[lead:], want[lead:]))
        for n, spec in cache_specs(cfg, B, S).items():
            key = {"k_win": "k", "v_win": "v"}.get(n, n)
            got = (spec.shape[1:], spec.spec(pctx)[1:])
            assert got in tails[key], (n, got, tails[key])


# -- the cases of tests/test_sharding.py, on the port ------------------------------

CTX = Ctx({"data": 16, "model": 16}, DEFAULT_RULES)


@pytest.mark.parametrize("shape, axes, want", [
    # divisible heads take model
    ((32, 16, 4096, 128), ("batch", "kv_heads", None, None),
     ("data", "model")),
    # granite: kv 8 not divisible by 16: the cache's seq takes model
    ((128, 8, 32768, 64), ("batch", "kv_heads", "kv_seq", None),
     ("data", None, "model")),
    # granite w_gate (E 40, d, f): experts fail, d takes model
    ((40, 1536, 512), ("experts", "moe_d", "mlp"), (None, "model")),
    # moonshot w_gate (E 64, d, f): experts take model, d falls to data
    ((64, 2048, 1408), ("experts", "moe_d", "mlp"), ("model", "data")),
    # moe_d's priority beats mlp's on w_down
    ((40, 512, 1536), ("experts", "mlp", "moe_d"), (None, None, "model")),
    # granite vocab 49155: ce_seq takes model
    ((256, 256, 49155), ("batch", "ce_seq", "vocab"), ("data", "model")),
    # gemma vocab 262144 divides: vocab wins, ce_seq replicated
    ((256, 256, 262144), ("batch", "ce_seq", "vocab"),
     ("data", None, "model")),
])
def test_resolver_cases_of_the_jax_tests(shape, axes, want):
    assert resolve_spec(shape, axes, CTX) == want
    assert tuple(jresolve(shape, axes, Ctx(CTX.sizes, JRULES))) == want
    assert P(*want) == jresolve(shape, axes, Ctx(CTX.sizes, JRULES))


def test_no_mesh_axis_used_twice():
    spec = resolve_spec((64, 64, 64), ("mlp", "qkv", "kv"), CTX)
    taken = [s for s in (spec + (None,) * 3)[:3] if s is not None]
    assert len(taken) == len(set(taken)) <= 1


def test_no_ctx_is_noop():
    assert resolve_spec((4, 4), ("batch", "mlp"), None) == ()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-67b"])
def test_params_mostly_sharded_on_a_pod(arch):
    """tests/test_sharding.py's: on a 16 x 16 mesh at least half the
    parameter bytes are split over 16 devices or more."""
    with use_mesh(make_mesh(16, 16)) as ctx:
        specs = param_specs(get_config(arch))
        shards = {n: spec_shards(s.spec(ctx), ctx) for n, s in specs.items()}
    total = sum(s.numel for s in specs.values())
    assert sum(s.numel for n, s in specs.items() if shards[n] >= 16) / total \
        > 0.5


def test_use_mesh_installs_and_restores():
    mesh = make_mesh(2, 2)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    with use_mesh(mesh) as ctx:
        assert isinstance(ctx, ShardingCtx) and ctx.axis_size("model") == 2
        assert resolve_spec((8, 8), ("embed_w", "mlp")) == ("data", "model")
    assert resolve_spec((8, 8), ("embed_w", "mlp")) == ()


def test_mesh_presets():
    assert MESHES == {"single": (1, 1), "quad": (1, 4)}
    quad = mesh_preset("quad")
    assert quad.shape == {"data": 1, "model": 4}
    assert [d.index for d in quad.devices.flat] == [0, 1, 2, 3]
    assert all(d.type == "cuda" for d in quad.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(2, 2, [torch.device("cuda", 0)])


@pytest.mark.parametrize("spec, sizes, n", [
    ((), {"data": 4}, 1), (("data",), {"data": 4, "model": 2}, 4),
    ((("data", "model"), None), {"data": 4, "model": 2}, 8),
    ((None, "model"), {"data": 4, "model": 2}, 2)])
def test_spec_shards(spec, sizes, n):
    assert spec_shards(spec, Ctx(sizes, DEFAULT_RULES)) == n


# -- ElasticRunner -------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_elastic_runner_picks_jax_s_mesh(n):
    seen, jseen = [], []
    runner = ElasticRunner(lambda ctx: seen.append(ctx.mesh.shape) or "step")
    jrunner = JElasticRunner(lambda ctx: jseen.append(dict(ctx.mesh.shape)))
    assert runner.ensure([torch.device("cuda", i) for i in range(n)]) \
        == "step"
    jrunner.ensure([jax.devices()[0]] * n)
    assert seen == jseen
    assert tuple(seen[0].values()) == viable_meshes(n)[-1]


def test_elastic_runner_rebuilds_only_on_a_new_shape():
    built = []
    runner = ElasticRunner(lambda ctx: built.append(ctx.mesh.shape)
                           or len(built))
    devs = [torch.device("cuda", i) for i in range(8)]
    steps = [runner.ensure(devs[:n]) for n in (4, 4, 2, 2, 4, 8, 8)]
    # viable_meshes(n)[-1] is the all-data (n, 1) layout
    assert [tuple(s.values()) for s in built] == [(4, 1), (2, 1), (4, 1),
                                                   (8, 1)]
    assert steps == [1, 1, 2, 2, 3, 4, 4]


def test_elastic_runner_installs_its_mesh_while_building():
    from repro_torch.distributed.sharding import current_ctx

    def build(ctx):
        assert current_ctx() is ctx
        return resolve_spec((8, 8), ("embed_w", "mlp"))
    runner = ElasticRunner(build)
    assert runner.ensure([torch.device("cuda", i) for i in range(4)]) == \
        ("data", "model")
    assert current_ctx() is None


def test_elastic_runner_defaults_to_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    runner = ElasticRunner(lambda ctx: ctx.mesh)
    mesh = runner.ensure()
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices.flat[0] == torch.device("cuda", 0)


def test_elastic_runner_keeps_its_checkpoint_manager_as_jax_s_does():
    mgr = object()
    for cls in (ElasticRunner, JElasticRunner):
        assert cls(lambda ctx: None, checkpoint_mgr=mgr).ckpt is mgr
        assert cls(lambda ctx: None).ckpt is None


def test_shapes_are_jax_s():
    assert {n: (s.seq_len, s.global_batch, s.kind)
            for n, s in SHAPES.items()} == \
        {n: (s.seq_len, s.global_batch, s.kind) for n, s in JSHAPES.items()}
    for arch in ARCHS:
        for n in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[n]) == \
                japplicable(jget_config(arch), JSHAPES[n])
