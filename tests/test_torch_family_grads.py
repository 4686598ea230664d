"""Every family's gradients against ``jax.value_and_grad``, on the CPU.

For each smoke arch of the port, the loss of ``loss_and_grads`` and every
gradient leaf against JAX's ``LM.loss`` differentiated by
``jax.value_and_grad``, both in f32 compute, on the same weights (drawn
by the port's ``init_params`` from materialize's distributions, seed 0,
and handed to JAX as its tree by ``to_jax_numpy``), on a batch of 2 x 64
tokens of SyntheticLM.

The tolerance of a leaf is its own rounding floor on these random
weights, measured here: every f32 weight of the port nudged one ulp up or
down at random (``np.nextafter``, the signs from a numpy generator of
seed 1), the port's gradients computed again, and the leaf's max
|nudged - unnudged| / max |g|, the largest over FLOOR_DRAWS draws. Each
leaf's max |port - JAX| / max |JAX| must be within twice its floor, or
within FLOOR_MIN where the floor is below it (test_torch_training.py's
leaf tolerance: a leaf that rounding barely moves still differs from JAX
by the two graphs' orders of summation), or, for the MoE archs, within
MOE_TOL: both packages round the expert activations to bf16
(``src/repro/models/layers.py:399-401``) at points where the two can
round an activation to neighbouring bf16 values (``tests/test_torch_moe.py``
holds the layer's y to JAX's at 2e-3 of its scale for that reason), a
step of up to 2^-8 of it that a 1-ulp nudge of the f32 weights need not
reproduce (moonshot's dense head layer's q / k gradients sit 3.0e-3 from
JAX's at S 64, in f32 and with both packages in f64 alike, while the
nudges move them 1.3e-4). Each floor must stay under FLOOR_CEILING, so a
floor that grows fails rather than widening its own tolerance. Losses
within 1e-5, or twice the loss's own floor where that is larger.

Where JAX's gradient has NaN elements the port's must be finite, and is
held to JAX's on the finite elements (the scale of a leaf their max
|JAX|). Two exponents overflow in JAX there, and the port guards both
before the exponent (``ROADMAP.md`` §3, differences by design):
* rwkv6-1.6b (``JAX_NAN``): its decay ``-exp(a)`` overflows for a > ~88
  before the clamp at -4 (``src/repro/models/rwkv.py:91-93``), and the
  gradient through the clamp is 0 * inf = NaN; the port clamps a first.
* zamba2-1.2b at S 512, where a chunk of 16 steps spans a log-decay above
  ~88: JAX's ``ssm_block`` masks after the exponent; the port masks the
  exponent's argument first.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.training import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.params import (from_jax_numpy, init_params,  # noqa: E402
                                to_jax_numpy)
from repro_torch.training import loss_and_grads  # noqa: E402

FLOOR_DRAWS = 4
# the archs whose JAX gradient has NaN elements at S 64 (see above)
JAX_NAN = {"rwkv6-1.6b"}
FLOOR_MIN = 1e-4         # test_torch_training.py's leaf tolerance
MOE_TOL = 4e-3           # twice test_torch_moe.py's 2e-3 of y's scale
# the floors reach 5.0e-3 at S 64 (zamba2's) and 0.13 at S 512, where
# zamba2's random-weight stack amplifies rounding the most
FLOOR_CEILING = {64: 0.02, 512: 0.25}


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread runs these as fast as eight, and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def leaf_of(got, path):
    for p in path:
        got = got[p.key]
    return got


def run(arch, seq):
    """(JAX loss, JAX grads, port loss, port grads by leaf, the floor by
    leaf and of the loss, the MoE allowance) at batch 2 x seq."""
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    tree = to_jax_numpy(init_params(cfg, seed=0, device="cpu",
                                    dtype=torch.float32), cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    b = {k: np.asarray(v) for k, v in JaxSyntheticLM(
        vocab=cfg.vocab, seq_len=seq, batch=2, seed=0).next_batch().items()}
    jl.set_compute_dtype(jnp.float32)
    try:
        jloss, jgrads = jax.value_and_grad(
            lambda p: JaxLM(jcfg).loss(p, b["tokens"], b["targets"]))(jparams)
    finally:
        jl.set_compute_dtype(jnp.bfloat16)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    def port(tr):
        lm = LM.from_params(cfg, from_jax_numpy(tr, cfg, "cpu",
                                                torch.float32))
        for p in lm.parameters():
            p.requires_grad_(True)
        loss, grads = loss_and_grads(lm, tb, TrainConfig())
        return float(loss), to_jax_numpy(grads, cfg)

    loss, got = port(tree)
    rng = np.random.default_rng(1)
    floor = {"loss": 0.0}
    for _ in range(FLOOR_DRAWS):
        nudged = jax.tree.map(
            lambda a: np.nextafter(a, np.where(rng.random(a.shape) < 0.5,
                                               -np.inf, np.inf).astype(a.dtype))
            if a.dtype == np.float32 else a, tree)
        moved_loss, moved = port(nudged)
        floor["loss"] = max(floor["loss"], abs(moved_loss - loss) / abs(loss))
        for path, _ in leaves(jgrads):
            g = leaf_of(got, path)
            k = jax.tree_util.keystr(path)
            rel = float(np.abs(leaf_of(moved, path) - g).max()
                        / max(np.abs(g).max(), 1e-30))
            floor[k] = max(floor.get(k, 0.0), rel)
    least = MOE_TOL if cfg.n_experts else FLOOR_MIN
    return float(jloss), jgrads, loss, got, floor, least


def check(arch, seq):
    """The loss, and each leaf where JAX's gradient is finite, against JAX
    (see above); every port leaf finite. Returns the number of leaves in
    which JAX's gradient has NaN."""
    jloss, jgrads, loss, got, floor, least = run(arch, seq)
    assert abs(loss - jloss) <= max(1e-5, 2 * floor["loss"]) * abs(jloss)
    high = {k: v for k, v in floor.items() if not v < FLOOR_CEILING[seq]}
    assert not high, high
    nan_leaves, bad = 0, {}
    for path, want in leaves(jgrads):
        k = jax.tree_util.keystr(path)
        want = np.asarray(want)
        g = leaf_of(got, path)
        assert g.shape == want.shape and np.isfinite(g).all(), k
        fin = np.isfinite(want)
        nan_leaves += not fin.all()
        if fin.any():
            scale = max(float(np.abs(want[fin]).max()), 1e-30)
            rel = float(np.abs(g[fin] - want[fin]).max()) / scale
            if not rel <= max(2 * floor[k], least):
                bad[k] = (rel, floor[k])
    assert not bad, bad
    return nan_leaves


@pytest.mark.parametrize("arch", ARCHS)
def test_family_grads_match_jax_at_the_rounding_floor(arch):
    assert (check(arch, 64) > 0) == (arch in JAX_NAN)


def test_zamba2_grads_finite_at_s512_and_match_jax_where_it_is_finite():
    """S 512 (32 chunks of 16): JAX's gradient is NaN in most leaves, the
    port's finite in all and equal to JAX's where JAX's is finite."""
    assert check("zamba2-1.2b", 512) > 0    # the reference's defect in view
