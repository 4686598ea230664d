"""The port's ``llm`` workload (``repro_torch.serving.llm``) against the
JAX package's: the chunk tasks field for field and the roll-up metadata,
for four archs of the three families, with the spec's token costs and with
a learned artifact's (applied as the JAX package's ``scenario.run`` applies
them, through ``ModelConfig.with_``); then the fifo, cfs and hybrid records
of ``execute_policy`` on a 1-minute llm trace in both packages."""
import importlib
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import simulate as jax_simulate  # noqa: E402
from repro.costmodel import model as jax_model  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro.traces import TraceSpec as JaxTraceSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import execute_policy  # noqa: E402
from repro_torch.costmodel import model  # noqa: E402
from repro_torch.serving import llm  # noqa: E402
from repro_torch.serving.request import RequestSpec, service_ms  # noqa: E402
from repro_torch.traces import TraceSpec  # noqa: E402

from test_engine_equivalence import _sim_record  # noqa: E402

jax_calibrate = importlib.import_module("repro.costmodel.calibrate")

ARCHS = ("deepseek-7b", "zamba2-1.2b", "granite-moe-3b-a800m", "gemma3-27b")
TRACE = dict(minutes=1, invocations_per_min=400.0, n_functions=30, seed=5)
TASK_KEYS = ("tid", "arrival", "service", "deadline", "mem_mb", "func_id")


def _stream(tasks):
    return [tuple(getattr(t, k) for k in TASK_KEYS) + (t.remaining,)
            for t in tasks]


@pytest.fixture(scope="module")
def artifact():
    return jax_calibrate.calibrate(mode="synthetic", seed=1)


def _specs(arch, costs, artifact):
    """The (port, JAX) LLMSpec pair, with each package's own config."""
    mine, ref = get_config(arch), jax_get_config(arch)
    if costs == "learned":
        seq = llm.LLMSpec().seq_len
        tc = model.LearnedCostModel(artifact).token_costs(mine, seq)
        assert tc == jax_model.LearnedCostModel(artifact).token_costs(
            ref, seq)
        mine = mine.with_(ms_per_ktoken_prefill=tc[0],
                          ms_per_token_decode=tc[1])
        ref = ref.with_(ms_per_ktoken_prefill=tc[0],
                        ms_per_token_decode=tc[1])
    return llm.LLMSpec(model=mine), jax_llm.LLMSpec(model=ref)


@pytest.mark.parametrize("costs", ("static", "learned"))
@pytest.mark.parametrize("arch", ARCHS)
def test_llm_workload_equals_jax(arch, costs, artifact):
    mine, ref = _specs(arch, costs, artifact)
    tasks, meta = llm.llm_workload(mine, TraceSpec(**TRACE))
    want, want_meta = jax_llm.llm_workload(ref, JaxTraceSpec(**TRACE))
    assert _stream(tasks) == _stream(want)
    assert meta == want_meta
    assert meta["n_chunks"] == len(tasks) > meta["n_requests"] > 0
    assert vars(mine.container_spec()) == vars(ref.container_spec())
    assert llm.approx_param_bytes(mine.resolve_model()) == \
        jax_llm.approx_param_bytes(ref.resolve_model())
    scaled, _ = llm.llm_workload(mine, TraceSpec(**TRACE), load_scale=1.5)
    ref_scaled, _ = jax_llm.llm_workload(ref, JaxTraceSpec(**TRACE),
                                         load_scale=1.5)
    assert _stream(scaled) == _stream(ref_scaled)


def test_requests_and_chunks_partition_the_service():
    spec = llm.LLMSpec(model="zamba2-1.2b", decode_chunk_tokens=100)
    reqs = llm.llm_requests(spec, TraceSpec(**TRACE))
    ref = jax_llm.llm_requests(jax_llm.LLMSpec(model="zamba2-1.2b",
                                               decode_chunk_tokens=100),
                               JaxTraceSpec(**TRACE))
    assert [vars(r) for r in reqs] == [vars(r) for r in ref]
    cfg = spec.resolve_model()
    for req in reqs[:50]:
        chunks = llm.request_chunks(cfg, spec, req)
        total = sum(t.service for t in chunks)
        assert total == pytest.approx(service_ms(cfg, req.prompt_tokens,
                                                 req.decode_tokens))
    one = RequestSpec(rid=0, arrival_ms=5.0, prompt_tokens=0,
                      decode_tokens=300)
    whole = llm.request_chunks(cfg, replace(spec, decode_chunk_tokens=0),
                               one)
    assert len(whole) == 1 and whole[0].arrival == 5.0


@pytest.fixture(scope="module")
def minute_trace():
    spec = dict(minutes=1, seed=2)
    return (llm.llm_workload(llm.LLMSpec(), TraceSpec(**spec))[0],
            jax_llm.llm_workload(jax_llm.LLMSpec(), JaxTraceSpec(**spec))[0])


@pytest.mark.parametrize("policy", ("fifo", "cfs", "hybrid"))
def test_policy_records_on_an_llm_trace_equal_jax(policy, minute_trace):
    mine, ref = minute_trace
    got = execute_policy(policy, mine, n_cores=50)
    want = jax_simulate.execute_policy(policy, ref, n_cores=50)
    assert _sim_record(got) == _sim_record(want)
    assert got.summary() == want.summary()
