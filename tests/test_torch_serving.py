"""The port's ServingEngine against the JAX engine on deepseek-7b smoke.

Both engines run in f32 compute on the same weights (the bridge) and the
same prompts, with the engine settings of test_serving.py:66-85. Tokens,
preemptions, completion times, bills and the adapter window must be
identical: scheduling depends only on token counts, and greedy tokens
agree when the logits agree to f32 rounding.
"""
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.core.hybrid import TimeLimitAdapter as JaxAdapter  # noqa: E402
from repro.costmodel.pricing import DEFAULT_PRICING as JAX_PRICING  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.models.layers import set_compute_dtype  # noqa: E402
from repro.serving import LiveRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import kv_bytes as jax_kv_bytes  # noqa: E402
from repro.serving import preemption_penalty_ms as jax_penalty  # noqa: E402
from repro_torch.configs import ModelConfig, get_smoke  # noqa: E402
from repro_torch.core.hybrid import TimeLimitAdapter  # noqa: E402
from repro_torch.costmodel.pricing import DEFAULT_PRICING  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402
from repro_torch.serving import (LiveRequest, ServingEngine,  # noqa: E402
                                 kv_bytes, preemption_penalty_ms)

ARCH = "deepseek-7b"
ENGINE_KW = dict(n_slots=3, n_fifo=2, max_len=48, initial_limit_ms=25.0)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_get_smoke(ARCH)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    params = from_jax_numpy(jax.tree.map(np.asarray, jparams),
                            get_smoke(ARCH), "cpu", torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (1, 6)) for _ in range(5)]
    set_compute_dtype(jnp.float32)
    try:
        jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
        for rid, p in enumerate(prompts):
            jeng.submit(JaxRequest(rid=rid, arrival_ms=0.0,
                                   tokens=jnp.asarray(p, jnp.int32),
                                   max_new=3 + rid * 3))
        jdone = jeng.run()
    finally:
        set_compute_dtype(jnp.bfloat16)
    eng = ServingEngine(get_smoke(ARCH), params, device="cpu", **ENGINE_KW)
    for rid, p in enumerate(prompts):
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0,
                               tokens=torch.from_numpy(p),
                               max_new=3 + rid * 3))
    done = eng.run()
    return jeng, jdone, eng, done


def test_engine_tokens_identical(engines):
    _, jdone, _, done = engines
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for a, b in zip(done, jdone):
        assert len(a.generated) == 3 + a.rid * 3
        assert a.generated == b.generated


def test_engine_preemptions_identical(engines):
    _, jdone, _, done = engines
    assert [r.preemptions for r in done] == [r.preemptions for r in jdone]
    assert sum(r.preemptions > 0 for r in done) == 4


def test_engine_completion_ms_identical(engines):
    _, jdone, _, done = engines
    assert [r.completion_ms for r in done] == [r.completion_ms for r in jdone]
    assert [r.first_run_ms for r in done] == [r.first_run_ms for r in jdone]


def test_engine_cost_identical(engines):
    _, jdone, _, done = engines
    assert [r.cost_usd() for r in done] == [r.cost_usd() for r in jdone]
    assert all(r.cost_usd() > 0 for r in done)


def test_engine_adapter_window_identical(engines):
    jeng, _, eng, _ = engines
    assert list(eng.adapter.window) == list(jeng.adapter.window)
    assert len(eng.adapter.window) == 5
    assert eng.adapter.limit() == jeng.adapter.limit()
    assert eng.now_ms == jeng.now_ms


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_bytes_and_penalty_match_jax(arch):
    jcfg = jax_get_config(arch)
    cfg = ModelConfig(**asdict(jcfg))
    for seq in (1, 1024, 32768):
        assert kv_bytes(cfg, seq) == jax_kv_bytes(jcfg, seq)
        assert preemption_penalty_ms(cfg, seq) == jax_penalty(jcfg, seq)


def test_time_limit_adapter_matches_jax():
    rng = np.random.default_rng(3)
    mine, ref = (TimeLimitAdapter(pct=90.0, window=7, initial_ms=50.0,
                                  record_series=True),
                 JaxAdapter(pct=90.0, window=7, initial_ms=50.0,
                            record_series=True))
    t = 0.0
    for i in range(60):
        t += float(rng.exponential(5.0))
        dur = float(rng.exponential(40.0))
        op = i % 3
        for a in (mine, ref):
            if op == 0:
                a.record(dur, t)
            elif op == 1:
                a.observe(dur, t + 1.0, tid=i)
        assert mine.limit(t) == ref.limit(t)
    mine.flush()
    ref.flush()
    assert mine.series == ref.series
    assert list(mine.window) == list(ref.window)


def test_pricing_copy_matches_jax():
    assert asdict(DEFAULT_PRICING) == asdict(JAX_PRICING)
    assert DEFAULT_PRICING.warm_hold_per_gb_second == \
        JAX_PRICING.warm_hold_per_gb_second
    assert DEFAULT_PRICING.price_per_ms(512) == JAX_PRICING.price_per_ms(512)


def test_engine_refuses_params_on_another_device():
    cfg = get_smoke(ARCH)
    from repro_torch.params import init_params
    params = {k: v.to("meta") for k, v in
              init_params(cfg, device="cpu").items()}
    with pytest.raises(ValueError, match="engine runs on cpu"):
        ServingEngine(cfg, params, device="cpu")


def test_serve_cli_engine_mode_on_cpu():
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "engine", "--device", "cpu"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 8
    for rid, line in enumerate(lines):
        assert line.startswith(f"req {rid}: tokens={4 + 2 * rid} ")
    assert any("preempt=0" not in line for line in lines)
