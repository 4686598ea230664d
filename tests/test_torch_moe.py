"""The port's MoE layer and the MoE / ``first_k_dense`` / GQA stacks against
the JAX package, on the smoke configs of granite-moe-3b-a800m (40 -> 4
experts, top 2, 6 heads over 2 KV heads: G = 3), moonshot-v1-16b-a3b (one
dense head layer, 8 experts, top 2) and deepseek-67b (8 heads over 2: G =
4).

Both run in f32 compute on the same weights (``materialize`` through the
bridge) and the same numpy inputs. Routing (expert ids, the stable sort,
the slots and the dropped set) must be equal; outputs within 2e-3 of
their scale (``tests/test_models.py:61``), the load-balance loss within
1e-5.
"""
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.distributed.params import is_spec  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import LM, layers  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.params import (from_jax_numpy, init_params,  # noqa: E402
                                jax_leaves)

GRANITE, MOONSHOT, DS67 = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
                           "deepseek-67b")
ARCHS = (GRANITE, MOONSHOT, DS67)
TOL = dict(rtol=2e-3, atol=2e-3)            # test_models.py:61
B, S = 2, 32


class f32_compute:
    """JAX's model in f32 compute, restored to bf16 on exit."""

    def __enter__(self):
        jl.set_compute_dtype(jnp.float32)

    def __exit__(self, *exc):
        jl.set_compute_dtype(jnp.bfloat16)


_TREES = {}


def tree_of(arch):
    """The JAX smoke parameters (jax arrays, numpy tree), drawn once."""
    if arch not in _TREES:
        jparams = materialize(model_specs(jax_get_smoke(arch)),
                              jax.random.PRNGKey(0))
        _TREES[arch] = jparams, jax.tree.map(np.asarray, jparams)
    return _TREES[arch]


def moe_pair(arch, capacity_factor, router=None):
    """The first body layer's MoE weights as a JAX dict and a port module
    (``router`` replaces the router), and both configs."""
    jcfg = jax_get_smoke(arch).with_(capacity_factor=capacity_factor)
    cfg = get_smoke(arch).with_(capacity_factor=capacity_factor)
    _, tree = tree_of(arch)
    leaves = {k: np.array(v[0]) for k, v in tree["blocks"]["moe"].items()}
    if router is not None:
        leaves["router"] = router.astype(np.float32)
    mod = layers.MoE(cfg, device="cpu", dtype=torch.float32)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in leaves.items()})
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in leaves.items()}, mod


def inputs(cfg, seed, shift=0.0):
    """(B, S, d) tokens; ``shift`` adds one direction u to every token and
    returns it, so a router column along u draws every token."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return (x + shift * u).astype(np.float32), u


def biased_router(arch, cfg, u):
    """The smoke's router with expert 0's column along u: every token
    ranks expert 0 first, so it holds B*S assignments against a capacity
    of S*K/E*1.25 a row, and drops."""
    _, tree = tree_of(arch)
    router = np.array(tree["blocks"]["moe"]["router"][0])
    router[:, 0] = 0.2 * u / np.sqrt(cfg.d_model)
    return router


def tied_router(arch):
    """Every column but expert 0's zero: experts 1.. tie exactly, so
    ``jax.lax.top_k``'s lower-index-first order decides who is chosen and
    in which order."""
    _, tree = tree_of(arch)
    router = np.zeros_like(tree["blocks"]["moe"]["router"][0])
    router[:, 0] = tree["blocks"]["moe"]["router"][0][:, 0]
    return router


def jax_routing(p, x, jcfg):
    """The routing and dispatch lines of ``repro.models.layers.moe``
    (``:378-393``), with JAX's own ``_dispatch_row``."""
    E, K = jcfg.n_experts, jcfg.top_k
    h = jl.rmsnorm(x, p["norm"], jcfg.norm_eps)
    logits = (h @ jl.bf16(p["router"])).astype(jnp.float32)
    probs = jax.nn.softmax(logits, -1)
    gates, eids = jax.lax.top_k(probs, K)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    C = max(int(x.shape[1] * K / E * jcfg.capacity_factor), 1)
    buf, meta = jax.vmap(
        lambda f, e, g: jl._dispatch_row(f, e, g, E, K, C))(h, eids, gates)
    return h, gates, eids, buf, meta, C


def port_routing(mod, x, cfg):
    h = layers.rmsnorm(x, mod.norm, cfg.norm_eps)
    _, eids, gates = layers.route(mod, h, cfg)
    C = layers.capacity(cfg, x.shape[1])
    buf, order, flat_idx = layers.dispatch(h, eids, cfg.n_experts, C)
    return gates, eids, buf, order, flat_idx, C


CASES = {"granite dropless": (GRANITE, 8.0, False),
         "granite drops": (GRANITE, 1.25, True),
         "moonshot dropless": (MOONSHOT, 8.0, False),
         "moonshot drops": (MOONSHOT, 1.25, True)}


def case_setup(name):
    arch, cf, biased = CASES[name]
    cfg = get_smoke(arch)
    x, u = inputs(cfg, seed=11, shift=2.0 if biased else 0.0)
    router = biased_router(arch, cfg, u) if biased else None
    return (*moe_pair(arch, cf, router), x, biased)


@pytest.mark.parametrize("name", CASES)
def test_moe_routing_matches_jax(name):
    """Expert ids, the stable sort by expert, every slot and the dropped
    set equal JAX's; the buffer and the gates to f32 rounding."""
    jcfg, cfg, jp, mod, x, biased = case_setup(name)
    with f32_compute():
        _, jgates, jeids, jbuf, (jorder, jflat, _), jC = jax_routing(
            jp, jnp.asarray(x), jcfg)
    gates, eids, buf, order, flat_idx, C = port_routing(
        mod, torch.from_numpy(x), cfg)
    E = cfg.n_experts
    assert C == jC
    np.testing.assert_array_equal(eids.numpy(), np.asarray(jeids))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(flat_idx.numpy(), np.asarray(jflat))
    dropped = flat_idx.numpy() == E * C
    np.testing.assert_array_equal(dropped, np.asarray(jflat) == E * C)
    assert dropped.any() == biased, dropped.sum()
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_moe_output_matches_jax(name):
    """``moe``'s y within 2e-3 of its scale and the load-balance loss
    within 1e-5; the combine alone on JAX's expert outputs to f32
    rounding."""
    jcfg, cfg, jp, mod, x, _ = case_setup(name)
    with f32_compute():
        jy, jaux = jl.moe(jp, jnp.asarray(x), jcfg)
        _, _, _, _, meta, _ = jax_routing(jp, jnp.asarray(x), jcfg)
    y, aux = layers.moe(mod, torch.from_numpy(x), cfg)
    scale = float(np.abs(np.asarray(jy)).max())
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 2e-3 * scale
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert layers.moe(mod, torch.from_numpy(x), cfg, aux=False)[1] is None
    # the combine on one (E, C, d) expert output for both
    C, E = layers.capacity(cfg, S), cfg.n_experts
    yexp = np.random.default_rng(5).standard_normal(
        (B, E, C, cfg.d_model)).astype(np.float32)
    order, flat_idx, s_gate = (np.array(m) for m in meta)
    jout = jax.vmap(lambda ye, o, f, g: jl._combine_row(
        ye, (o, f, g), S, cfg.top_k, cfg.d_model))(
            jnp.asarray(yexp), order, flat_idx, s_gate)
    gates = np.take_along_axis(s_gate, np.argsort(order, axis=1), axis=1)
    out = layers.combine(
        torch.from_numpy(yexp),
        layers.slots_of(torch.from_numpy(order).long(),
                        torch.from_numpy(flat_idx).long()),
        torch.from_numpy(gates).view(B, S, cfg.top_k))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", (GRANITE, MOONSHOT))
def test_moe_tie_order_matches_jax(arch):
    """Experts 1.. tie exactly: tokens whose expert-0 logit is negative
    take experts 1 and 2 in that order, the others 0 then 1, as
    ``jax.lax.top_k`` orders ties (lower index first); expert 1 then
    holds every token and drops past its capacity, in the stable sort's
    order."""
    jcfg, cfg, jp, mod = moe_pair(arch, 1.25, tied_router(arch))
    x, _ = inputs(cfg, seed=13)
    with f32_compute():
        _, _, jeids, _, (_, jflat, _), C = jax_routing(jp, jnp.asarray(x),
                                                       jcfg)
        jy, _ = jl.moe(jp, jnp.asarray(x), jcfg)
    _, eids, _, _, flat_idx, _ = port_routing(mod, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(jeids))
    np.testing.assert_array_equal(flat_idx.numpy(), np.asarray(jflat))
    pairs = {tuple(e) for e in eids.numpy().reshape(-1, 2).tolist()}
    assert pairs == {(0, 1), (1, 2)}
    assert (flat_idx.numpy() == cfg.n_experts * C).any()
    y, _ = layers.moe(mod, torch.from_numpy(x), cfg)
    scale = float(np.abs(np.asarray(jy)).max())
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 2e-3 * scale


def test_moe_records_routes_when_asked():
    """``routes`` collects ids, slots (E * C where dropped) and the K-th
    vs (K+1)-th probability margin; the serving path records nothing."""
    _, cfg, _, mod, x, _ = case_setup("granite drops")
    assert mod.routes is None
    mod.routes = []
    layers.moe(mod, torch.from_numpy(x), cfg)
    (r,) = mod.routes
    C = layers.capacity(cfg, S)
    assert r["capacity"] == C and r["eids"].shape == (B, S, cfg.top_k)
    assert r["slots"].shape == (B, S * cfg.top_k)
    assert (r["slots"] == cfg.n_experts * C).any()
    assert (r["margin"] >= 0).all() and r["margin"].shape == (B, S)


def test_capacity_at_full_width():
    """granite's real capacity factor (1.25): 150 slots an expert for a
    600-token prompt, 1 at a decode step, where nothing drops (a token's
    K experts are distinct)."""
    cfg = get_config(GRANITE)
    assert cfg.capacity_factor == 1.25
    assert layers.capacity(cfg, 600) == 150
    assert layers.capacity(cfg, 513) == int(513 * 8 / 40 * 1.25)
    assert layers.capacity(cfg, 1) == 1


def test_route_agreement_counts_moved_and_dropped_choices():
    """``path_check.route_agreement`` on two runs of the smoke at capacity
    1.25: none moved between identical runs; a perturbed router moves
    some token choices, and the count is the tokens whose expert set
    differs."""
    from repro_torch.kernels import plain
    from repro_torch.launch import path_check as pc
    cfg = get_smoke(GRANITE).with_(capacity_factor=1.25)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    toks = pc.prompt(cfg, "cpu")
    ra, rb, rc = [], [], []
    pc.path_logits(cfg, params, plain, toks, ra)
    pc.path_logits(cfg, params, plain, toks, rb)
    same = pc.route_agreement(ra, rb, cfg.n_experts)
    calls = 1 + pc.STEPS
    assert len(ra) == cfg.n_layers and all(len(r) == calls for r in ra)
    assert same["tokens"] == cfg.n_layers * (pc.PROMPT + pc.STEPS)
    assert same["moved"] == same["dropped"] == 0
    assert same["first"] is None and same["margin"] >= 0.0
    name = "layers.1.moe.router"
    g = torch.Generator().manual_seed(0)
    noisy = dict(params, **{name: params[name] + 0.05 * torch.randn(
        params[name].shape, generator=g)})
    pc.path_logits(cfg, noisy, plain, toks, rc)
    moved = pc.route_agreement(rc, rb, cfg.n_experts)
    want = 0
    for x, y in zip(rc[1], rb[1]):
        sx = torch.sort(x["eids"], -1).values
        sy = torch.sort(y["eids"], -1).values
        want += int((sx != sy).any(-1).sum())
    assert moved["moved"] == want > 0
    call, layer, n, margin, rel = moved["first"]
    assert (call, layer) == (0, 1) and 0 < n <= want
    assert 0.0 < margin and 0.0 < rel <= 1.0
    assert "first moved in call 0" in pc.route_line(moved)
    # the perturbed run on the other run's routes moves none; its gates
    # are its own router's
    rf = []
    pc.path_logits(cfg, noisy, plain, toks, rf, forced=rb)
    assert pc.route_agreement(rf, rb, cfg.n_experts)["moved"] == 0
    assert not torch.equal(rf[1][0]["kth"], rb[1][0]["kth"])


def test_unrounded_activations_is_undone_and_departs_from_the_model():
    """The path check's measurement without the bf16 rounding of the
    expert activations changes the output within its block only."""
    from repro_torch.launch import path_check as pc
    _, cfg, _, mod, x, _ = case_setup("granite dropless")
    xt = torch.from_numpy(x)
    y, _ = layers.moe(mod, xt, cfg)
    with pc.unrounded_activations():
        y32, _ = layers.moe(mod, xt, cfg)
    assert not torch.equal(y, y32)
    assert torch.equal(layers.moe(mod, xt, cfg)[0], y)


# -- the stacks ---------------------------------------------------------------


def tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


def port_lm(arch):
    _, tree = tree_of(arch)
    cfg = get_smoke(arch)
    return LM.from_params(cfg, from_jax_numpy(tree, cfg, "cpu",
                                              torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch):
    assert asdict(get_config(arch)) == asdict(jax_get_config(arch))
    assert asdict(get_smoke(arch)) == asdict(jax_get_smoke(arch))
    check_supported(get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_train_matches_jax(arch):
    jparams, _ = tree_of(arch)
    toks = tokens((2, 24))
    with f32_compute():
        exp = JaxLM(jax_get_smoke(arch)).logits_train(jparams,
                                                      jnp.asarray(toks))
    out = port_lm(arch).logits_train(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and tuple(out.shape) == exp.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill plus 4 teacher-forced decode steps; the port's one (L, ...)
    cache holds JAX's ``head`` layers, then its ``body``."""
    jcfg = jax_get_smoke(arch)
    jparams, _ = tree_of(arch)
    Bt, St, extra = 2, 20, 4
    toks = tokens((Bt, St + extra), seed=7)
    jlm = JaxLM(jcfg)
    with f32_compute():
        jlogits, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :St]),
                                      max_len=St + extra)
        jsteps = []
        for i in range(extra):
            jd, jcache = jlm.decode_step(
                jparams, jnp.asarray(toks[:, St + i]), jcache,
                jnp.full((Bt,), St + i, jnp.int32))
            jsteps.append(np.asarray(jd))
    lm = port_lm(arch)
    logits, cache = lm.prefill(torch.from_numpy(toks[:, :St]), St + extra)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i in range(extra):
        d, cache = lm.decode_step(torch.from_numpy(toks[:, St + i]), cache,
                                  torch.full((Bt,), St + i))
        np.testing.assert_allclose(d.numpy(), jsteps[i], **TOL)
    for name in ("k", "v"):
        jkv = np.concatenate([np.asarray(jcache[part][name]) for part in
                              ("head", "body") if part in jcache])
        assert cache[name].shape == jkv.shape
        np.testing.assert_allclose(cache[name].numpy(), jkv, **TOL)


@pytest.mark.parametrize("arch", (GRANITE, MOONSHOT))
def test_init_params_std_matches_materialize(arch):
    """Leaf by leaf, the on-device initialiser draws the MoE and head
    leaves with materialize's std: fan_in = the stack count (body
    n_layers - first_k_dense, head first_k_dense)."""
    cfg = get_smoke(arch)
    _, tree = tree_of(arch)
    p = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    checked = set()
    for path, leaf in jax_leaves(cfg).items():
        if path[0] not in ("blocks", "head_layers"):
            continue
        ref = tree
        for k in path:
            ref = ref[k]
        mine = np.stack([p[n].numpy() for n in leaf.names])
        assert mine.shape == ref.shape, path
        if not ref.any():
            assert not mine.any(), path
            continue
        np.testing.assert_allclose(mine.std(), ref.std(), rtol=0.06,
                                   err_msg=str(path))
        checked.add(path[:2])
    want = {("blocks", "attn"), ("blocks", "moe")}
    if cfg.first_k_dense:
        want |= {("head_layers", "attn"), ("head_layers", "mlp")}
    assert checked == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_std_rule_at_full_width(arch):
    """The full-width leaf table against the JAX ParamSpecs (no arrays):
    every path, shape and std; granite's expert w_down has std
    (1/sqrt(64))/sqrt(32)."""
    cfg = get_config(arch)
    specs = model_specs(jax_get_config(arch))
    leaves = jax_leaves(cfg)
    n_specs = len(jax.tree.leaves(specs, is_leaf=is_spec))
    assert len(leaves) == n_specs
    for path, leaf in leaves.items():
        spec = specs
        for k in path:
            spec = spec[k]
        assert is_spec(spec) and spec.shape == leaf.shape, path
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
        if spec.init == "zeros":
            assert leaf.init == "zeros"
        else:
            assert leaf.std == pytest.approx(spec.scale / np.sqrt(fan_in))
        assert len(leaf.names) == int(np.prod(leaf.shape[:leaf.stacked]))
    if arch == GRANITE:
        assert leaves[("blocks", "moe", "w_down")].std == pytest.approx(
            1 / np.sqrt(64) / np.sqrt(32))
