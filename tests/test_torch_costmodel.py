"""The port's cost model against the JAX package's on the same inputs: the
synthetic calibration (the whole artifact, as exact JSON), the ridge fit,
predictions and MAPE bit for bit, the online estimators over seeded
streams, ``LearnedCostModel``'s hooks for every arch, ``make_cost_model``'s
coercions and artifacts crossing between the packages. The kernel rows
come from the port's own wrappers on the meta device (``kernels.costs``),
not from HLO as in the JAX package, so they are held against the cost
formulas instead; the measure mode runs here on the CPU's plain versions
and raises where no device is given and there is no card."""
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.costmodel import features as jax_features  # noqa: E402
from repro.costmodel import model as jax_model  # noqa: E402
from repro.costmodel import online as jax_online  # noqa: E402
from repro.costmodel import pricing as jax_pricing  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.costmodel import model, online, pricing  # noqa: E402
from repro_torch.costmodel import features  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402

# the packages export a function of the module's name
calibrate = importlib.import_module("repro_torch.costmodel.calibrate")
jax_calibrate = importlib.import_module("repro.costmodel.calibrate")

MODELS = ("deepseek-7b", "zamba2-1.2b")
ROW_KEYS = {"op", "flops", "bytes", "trips", "measured_ms", "predicted_ms"}


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


@pytest.mark.parametrize("model_name", MODELS)
@pytest.mark.parametrize("seed", range(4))
def test_synthetic_calibration_is_jax_bit_for_bit(seed, model_name):
    got = calibrate.calibrate(mode="synthetic", seed=seed, model=model_name)
    want = jax_calibrate.calibrate(mode="synthetic", seed=seed,
                                   model=model_name)
    assert _dump(got) == _dump(want)


def _seeded_rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"op": f"r{i}", "flops": float(rng.uniform(1e5, 3e9)),
             "bytes": float(rng.uniform(1e4, 1e8)), "trips": 1,
             "measured_ms": float(rng.uniform(0.01, 50.0))}
            for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_fit_predict_and_mape_are_jax_bit_for_bit(seed):
    rows = _seeded_rows(seed, 3 + seed)
    for l2 in (1e-6, 0.5):
        w = calibrate.fit_ridge(rows, l2=l2)
        assert w == jax_calibrate.fit_ridge(rows, l2=l2)
        assert all(x >= 0.0 for x in w)
        for r in rows:
            assert calibrate.predict_ms(w, r) == \
                jax_calibrate.predict_ms(w, r)
        assert calibrate.mape(rows, w) == jax_calibrate.mape(rows, w)
    A = [[float(v) for v in row] for row in
         np.random.default_rng(seed).standard_normal((3, 3))]
    b = [1.0, -2.0, 0.5]
    assert calibrate._solve3(A, b) == jax_calibrate._solve3(A, b)
    with pytest.raises(ValueError):
        calibrate.fit_ridge(rows[:2])


@pytest.mark.parametrize("seed", range(3))
def test_online_estimators_are_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    xs, ys = rng.uniform(0, 4, 200), rng.uniform(0, 3000, 200)
    mine = online.ScalarRLS(prior_coeff=900.0, prior_weight=10.0, lam=0.97)
    ref = jax_online.ScalarRLS(prior_coeff=900.0, prior_weight=10.0,
                               lam=0.97)
    for x, y in zip(xs.tolist(), ys.tolist()):
        assert mine.observe(x, y) == ref.observe(x, y)
        assert mine.coeff == ref.coeff
    assert mine.snapshot() == ref.snapshot()
    frozen = online.ScalarRLS(prior_coeff=5.0, learn=False)
    frozen.observe(1.0, 100.0)
    assert frozen.coeff == 5.0
    e, je = online.EwmaRate(alpha=0.3), jax_online.EwmaRate(alpha=0.3)
    keys = rng.integers(0, 5, 300).tolist()
    counts = rng.poisson(7.0, 300).tolist()
    for k, c in zip(keys, counts):
        assert e.update(k, c) == je.update(k, c)
    assert [e.forecast(k) for k in range(7)] == \
        [je.forecast(k) for k in range(7)]
    assert e.n_updates == je.n_updates
    with pytest.raises(ValueError):
        online.EwmaRate(alpha=0.0)


@pytest.fixture(scope="module")
def artifacts():
    return {seed: jax_calibrate.calibrate(mode="synthetic", seed=seed)
            for seed in (0, 2)}


@pytest.mark.parametrize("arch", ARCHS)
def test_learned_token_costs_match_jax(arch, artifacts):
    for art in artifacts.values():
        mine = model.LearnedCostModel(art)
        ref = jax_model.LearnedCostModel(art)
        for seq in (1024, 4096):
            got = mine.token_costs(get_config(arch), seq)
            assert got == ref.token_costs(jax_get_config(arch), seq)
            assert got is not None and all(v > 0 for v in got)
        assert mine.queue_ms_per_load() == ref.queue_ms_per_load()
        for budget in (0.0, 500.0, 4e4):
            assert mine.derive_max_load(budget) == \
                ref.derive_max_load(budget)
        assert mine.describe() == ref.describe()
        for row in art["rows"]:
            assert mine.predict_op_ms(row) == ref.predict_op_ms(row)


def test_learned_model_hooks_and_online_half(artifacts):
    art = artifacts[0]
    ref_cfg = get_config("deepseek-7b")
    mine = model.LearnedCostModel(art)
    # the calibration's own reference: the anchored spec constants
    assert mine.token_costs(ref_cfg, 4096) == (
        ref_cfg.ms_per_ktoken_prefill, ref_cfg.ms_per_token_decode)
    ref = jax_model.LearnedCostModel(art)
    for x, y in ((1.0, 800.0), (2.5, 4000.0), (0.5, 100.0)):
        assert mine.observe(x, y) == ref.observe(x, y)
    assert mine.describe() == ref.describe()
    assert mine.prewarm_forecast() == "ewma"
    static = model.StaticCostModel()
    assert static.token_costs(ref_cfg, 4096) is None
    assert static.queue_ms_per_load() == model.STATIC_QUEUE_MS_PER_LOAD
    assert static.derive_max_load(3000.0) == \
        jax_model.StaticCostModel().derive_max_load(3000.0)
    assert static.describe() == jax_model.StaticCostModel().describe()
    no_tc = dict(art, token_costs=None)
    assert model.LearnedCostModel(no_tc).token_costs(ref_cfg, 1024) is None


def test_make_cost_model_on_every_coercion(artifacts, tmp_path,
                                           monkeypatch):
    art = artifacts[2]
    for arg in (None, "static"):
        for p in (None, "premium", {"name": "x", "price_per_request": 0.0}):
            got = model.make_cost_model(arg, p)
            want = jax_model.make_cost_model(arg, p)
            assert got.describe() == want.describe()
            assert got.pricing.name == want.pricing.name
    got = model.make_cost_model(art, "free_requests")
    assert isinstance(got, model.LearnedCostModel)
    assert got.describe() == \
        jax_model.make_cost_model(art, "free_requests").describe()
    path = calibrate.save_artifact(art, tmp_path / "a.json")
    assert model.make_cost_model(str(path)).weights == art["weights"]
    keep = model.StaticCostModel()
    assert model.make_cost_model(keep) is keep
    assert model.make_cost_model(keep, "premium").pricing.name == "premium"
    with pytest.raises(TypeError):
        model.make_cost_model(3.5)
    with pytest.raises(KeyError):
        model.make_cost_model(None, "no-such-preset")
    # "learned": the default artifact where it exists, else a fresh
    # synthetic calibration, in both packages
    monkeypatch.chdir(tmp_path)
    fresh = model.make_cost_model("learned")
    assert fresh.artifact == calibrate.calibrate(mode="synthetic")
    assert fresh.describe() == jax_model.make_cost_model("learned").describe()
    other = calibrate.calibrate(mode="synthetic", seed=5)
    written = calibrate.save_artifact(other)
    assert written == Path("results/costmodel/calibration_v1.json")
    assert model.make_cost_model("learned").artifact == other
    assert jax_model.make_cost_model("learned").artifact == other


def test_pricing_coercions_match_jax():
    assert vars(pricing.DEFAULT_PRICING) == vars(jax_pricing.DEFAULT_PRICING)
    for name in pricing.PRICINGS:
        assert vars(pricing.PRICINGS[name]) == vars(jax_pricing.PRICINGS[name])
        assert vars(pricing.make_pricing(name)) == \
            vars(jax_pricing.make_pricing(name))
    assert pricing.resolve_pricing(None) is None
    assert vars(pricing.make_pricing({"price_per_request": 1e-6})) == \
        vars(jax_pricing.make_pricing({"price_per_request": 1e-6}))
    with pytest.raises(TypeError):
        pricing.make_pricing(7)


def test_artifacts_cross_between_the_packages(tmp_path):
    mine = calibrate.calibrate(mode="synthetic", seed=3,
                               model="granite-moe-3b-a800m")
    p1 = calibrate.save_artifact(mine, tmp_path / "port.json")
    loaded = jax_calibrate.load_artifact(p1)
    assert loaded == mine
    theirs = jax_calibrate.calibrate(mode="synthetic", seed=1)
    p2 = jax_calibrate.save_artifact(theirs, tmp_path / "jax.json")
    assert calibrate.load_artifact(p2) == theirs
    assert p1.read_text() == jax_calibrate.save_artifact(
        mine, tmp_path / "again.json").read_text()
    cfg = get_config("gemma3-27b")
    assert model.LearnedCostModel(str(p2)).token_costs(cfg, 4096) == \
        jax_model.LearnedCostModel(str(p2)).token_costs(
            jax_get_config("gemma3-27b"), 4096)


def test_load_artifact_refuses_wrong_kind_and_version(tmp_path):
    art = calibrate.calibrate(mode="synthetic")
    bad_kind = tmp_path / "kind.json"
    bad_kind.write_text(json.dumps(dict(art, kind="something-else")))
    with pytest.raises(ValueError, match="not a"):
        calibrate.load_artifact(bad_kind)
    bad_version = tmp_path / "version.json"
    bad_version.write_text(json.dumps(dict(art, version=2)))
    with pytest.raises(ValueError, match="version"):
        calibrate.load_artifact(bad_version)
    with pytest.raises(KeyError):
        calibrate.calibrate(mode="nonsense")


def _formula(op: str, small: bool):
    BH, S, hd, ds = features.kernel_shapes(small)
    f32 = torch.float32
    from repro_torch.kernels.rwkv6_scan import CHUNK
    return {
        "flash_attention": costs.flash(BH, BH, S, S, hd, f32),
        "decode_attention": costs.decode(BH, BH, hd, f32, BH * S, BH * S),
        "ssm_scan": costs.ssm(BH, BH, S, hd, ds, features.SSM_CHUNK, f32),
        "rwkv6_scan": costs.rwkv(BH, BH, S, hd, f32, CHUNK),
        "fused_rmsnorm": costs.rmsnorm(S * BH, 4 * hd, f32),
    }[op]


@pytest.mark.parametrize("small", (True, False))
def test_kernel_features_equal_the_cost_formulas(small):
    rows = features.kernel_features(small)
    assert [r["op"] for r in rows] == [n for n, _ in
                                       features._kernel_cases(small)]
    for r in rows:
        nbytes, flops, _ = _formula(r["op"], small)
        assert (r["bytes"], r["flops"], r["trips"]) == \
            (float(nbytes), float(flops), 1)
        assert set(r) == set(features.FEATURE_KEYS)
    only = features.kernel_features(small, ops_filter=["ssm_scan"])
    assert only == [r for r in rows if r["op"] == "ssm_scan"]


def test_kernel_cases_draw_the_jax_inputs():
    """The same numpy draws as the JAX package's cases: every input but
    the ssm case's cumulative log-decay (a cumsum of its own) equal."""
    mine = dict(features._kernel_cases(True))
    for name, builder in jax_features._kernel_cases(True):
        _, want = builder()
        _, got = mine[name]()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            if name == "ssm_scan" and g.dim() == 2:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), w)


def test_measure_mode_on_the_cpu_gives_jax_rows_and_a_loadable_artifact(
        tmp_path):
    art = calibrate.calibrate(mode="measure", device="cpu", repeats=2)
    ref = jax_calibrate.calibrate(mode="synthetic")
    assert set(art) == set(ref)
    assert art["mode"] == "measure"
    assert [r["op"] for r in art["rows"]] == [n for n, _ in
                                              features._kernel_cases(True)]
    for r in art["rows"]:
        assert set(r) == ROW_KEYS
        assert r["measured_ms"] > 0.0
        assert r["predicted_ms"] == calibrate.predict_ms(art["weights"], r)
    assert art["token_costs"]["model"] == "deepseek-7b"
    path = calibrate.save_artifact(art, tmp_path / "m.json")
    learned = model.LearnedCostModel(str(path))
    assert learned.weights == art["weights"]
    assert jax_model.LearnedCostModel(str(path)).token_costs(
        jax_get_config("rwkv6-1.6b"), 4096) == \
        learned.token_costs(get_config("rwkv6-1.6b"), 4096)


def test_measure_mode_without_a_device_raises_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card's route runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.calibrate(mode="measure")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.measure_kernels()
