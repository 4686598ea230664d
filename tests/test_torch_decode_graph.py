"""The port's slot-state engine (repro_torch.serving.graphs) on the CPU.

Every slot owns a preallocated cache; a request is prefilled into its
slot, copied out when it is preempted and copied into the slot that
restores it. On the card each slot's decode step is a CUDA graph; on
the CPU the same slot code runs ``LM.decode_step`` eagerly, so these
tests hold the swaps and the scheduling:

* the engine against the JAX engine on the deepseek-7b, zamba2-1.2b,
  rwkv6-1.6b, granite-moe-3b-a800m, qwen2-vl-2b (M-RoPE, GQA, tied head)
  and musicgen-large smoke configs in f32 (as ``tests/test_serving.py:66``
  serves qwen2-vl): tokens,
  preemptions, completion times, bills and the adapter window identical,
  with requests restored into another slot than the one they left;
* logits after a swap out and in bitwise equal to a request that kept
  its own cache, and a prefill into a used slot equal to a fresh one;
* the launch bookkeeping of a captured step (replays times the launches
  of one capture; warm-up and capture left out), with the CUDA graph API
  replaced by stand-ins.

The replay against the eager step on the card is in test_torch_cuda.py.
"""
from contextlib import contextmanager, nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.distributed import materialize  # noqa: E402
from repro.models import model_specs  # noqa: E402
from repro.models.layers import set_compute_dtype  # noqa: E402
from repro.serving import LiveRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import decode_attention, fused_rmsnorm, ops  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.params import from_jax_numpy, init_params  # noqa: E402
from repro_torch.serving import LiveRequest, ServingEngine  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402

ARCHS = ("deepseek-7b", "zamba2-1.2b", "rwkv6-1.6b", "granite-moe-3b-a800m",
         "qwen2-vl-2b", "musicgen-large")
# two fair slots (2, 3): a request preempted from a FIFO slot comes back
# in another slot, and fair slices rotate requests between the two
ENGINE_KW = dict(n_slots=4, n_fifo=2, max_len=48, initial_limit_ms=12.0)
PROMPTS = (6, 17, 9, 20, 3, 11)


def _params(cfg):
    return init_params(cfg, seed=0, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = jax_get_smoke(arch)
    jparams = materialize(model_specs(jcfg), jax.random.PRNGKey(0))
    p32 = from_jax_numpy(jax.tree.map(np.asarray, jparams), get_smoke(arch),
                         "cpu", torch.float32)
    return arch, jcfg, jparams, p32


@pytest.fixture(scope="module")
def engines(setup):
    arch, jcfg, jparams, p32 = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (1, n)) for n in PROMPTS]
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
    eng = ServingEngine(get_smoke(arch), p32, device="cpu", **ENGINE_KW)
    swaps = []                              # (kind, rid, slot, cache)
    swap_out, swap_in = eng._swap_out, eng._swap_in

    def logged_out(i, req):
        swap_out(i, req)
        swaps.append(("out", req.rid, i, req.cache))

    def logged_in(i, req):
        swaps.append(("in", req.rid, i, req.cache))
        swap_in(i, req)

    eng._swap_out, eng._swap_in = logged_out, logged_in
    for rid, p in enumerate(prompts):
        eng.submit(LiveRequest(rid=rid, arrival_ms=0.0,
                               tokens=torch.from_numpy(p),
                               max_new=3 + rid * 3))
    done = eng.run()
    return jeng, jdone, eng, done, swaps


def test_slot_engine_matches_jax(engines):
    jeng, jdone, eng, done, swaps = engines
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for a, b in zip(done, jdone):
        assert len(a.generated) == 3 + a.rid * 3
        assert a.generated == b.generated
    assert [r.preemptions for r in done] == [r.preemptions for r in jdone]
    assert [r.completion_ms for r in done] == [r.completion_ms for r in jdone]
    assert [r.first_run_ms for r in done] == [r.first_run_ms for r in jdone]
    assert [r.cost_usd() for r in done] == [r.cost_usd() for r in jdone]
    assert list(eng.adapter.window) == list(jeng.adapter.window)
    assert eng.adapter.limit() == jeng.adapter.limit()
    assert eng.now_ms == jeng.now_ms
    left = {}
    moved = 0
    for kind, rid, slot, _ in swaps:
        if kind == "out":
            left[rid] = slot
        else:
            moved += slot != left[rid]
    assert moved >= 1


def test_slot_engine_swaps_state_out_and_back(engines):
    _, _, eng, done, swaps = engines
    outs = [s for s in swaps if s[0] == "out"]
    ins = [s for s in swaps if s[0] == "in"]
    # every preemption saved the slot's state, and every saved state was
    # copied back (each request completes) exactly as it was saved
    assert len(outs) == sum(r.preemptions for r in done) == len(ins)
    assert len(outs) >= 2
    for kind, rid, slot, cache in ins:
        saved = [s for s in outs if s[1] == rid]
        assert saved and saved[0][3] is cache
        outs.remove(saved[0])
    assert all(r.cache is None for r in done)
    assert [r.rid for r in eng.slots if r is not None] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_swap_out_and_in_keeps_the_logits_bitwise(arch):
    """A request that leaves slot 0, whose cache is then reused by another
    prompt, and comes back in slot 1 decodes exactly as a twin that kept
    its own cache."""
    cfg = get_smoke(arch)
    lm = LM.from_params(cfg, _params(cfg))
    dec = graphs.SlotDecoder(lm, n_slots=2, max_len=32)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 9)))
    other = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 13)))
    with torch.inference_mode():
        logits, twin = lm.prefill(prompt, 32)
        assert torch.equal(dec.prefill(0, prompt), logits)
        tok, slot = int(logits[0, -1].argmax()), 0
        for pos in range(9, 15):
            if pos == 11:
                saved = dec.save(0)
                dec.prefill(0, other)             # the slot is reused
                dec.step(0, 7, 13)
                dec.load(1, saved)
                slot = 1
            got = dec.step(slot, tok, pos).clone()
            want, twin = lm.decode_step(torch.tensor([tok]), twin,
                                        torch.tensor([pos]))
            assert torch.equal(got, want), f"step at {pos} in slot {slot}"
            tok = int(want[0, -1].argmax())
        for name, t in dec.caches[1].items():
            assert torch.equal(t, twin[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_a_used_cache_equals_a_fresh_one(arch):
    cfg = get_smoke(arch)
    lm = LM.from_params(cfg, _params(cfg))
    rng = np.random.default_rng(6)
    long, short = (torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)))
                   for n in (20, 7))
    with torch.inference_mode():
        _, used = lm.prefill(long, 24)
        lm.decode_step(torch.tensor([3]), used, torch.tensor([20]))
        logits, cache = lm.prefill(short, 24, cache=used)
        want_logits, want = lm.prefill(short, 24)
    assert cache is used
    assert torch.equal(logits, want_logits)
    assert cache.keys() == want.keys()
    for name in want:
        assert torch.equal(cache[name], want[name]), name


def test_prefill_refuses_a_cache_of_another_layout():
    cfg = get_smoke("deepseek-7b")
    lm = LM.from_params(cfg, _params(cfg))
    toks = torch.zeros(1, 4, dtype=torch.int64)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="not the layout"):
            lm.prefill(toks, 16, cache=lm.new_cache(1, 24))
        with pytest.raises(ValueError, match="not the layout"):
            lm.prefill(toks, 16, cache=lm.new_cache(2, 16))


def test_slot_decoder_on_the_cpu_steps_eagerly_and_counts_nothing():
    cfg = get_smoke("deepseek-7b")
    lm = LM.from_params(cfg, _params(cfg))
    dec = graphs.SlotDecoder(lm, n_slots=3, max_len=16)
    assert dec.graphs == [None, None, None]
    ops.reset_launch_counts()
    with torch.inference_mode():
        dec.prefill(2, torch.ones(1, 5, dtype=torch.int64))
        twin = {n: t.clone() for n, t in dec.caches[2].items()}
        got = dec.step(2, 4, 5)
        want, _ = lm.decode_step(torch.tensor([4]), twin, torch.tensor([5]))
    assert dec.tokens[2].tolist() == [4] and dec.pos[2].tolist() == [5]
    assert torch.equal(got, want)
    assert set(ops.launch_counts().values()) == {0}


# -- launch bookkeeping of a captured step ----------------------------------


def test_uncounted_takes_launches_out_and_add_launches_puts_them_back():
    ops.reset_launch_counts()
    fused_rmsnorm.launches = 5
    with ops.uncounted() as inside:
        fused_rmsnorm.launches += 4
        decode_attention.launches += 2
    assert inside == {**{n: 0 for n in ops.launch_counts()},
                      "fused_rmsnorm": 4, "decode_attention": 2}
    assert ops.launch_counts()["fused_rmsnorm"] == 5
    assert ops.launch_counts()["decode_attention"] == 0
    ops.add_launches(inside)
    ops.add_launches(inside)
    assert ops.launch_counts()["fused_rmsnorm"] == 13
    assert ops.launch_counts()["decode_attention"] == 4
    ops.reset_launch_counts()


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a capture runs the Python of
    the step, as a real one does, and a replay runs none of it."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_step_counts_replays_not_warmup_or_capture(monkeypatch):
    pools = []

    @contextmanager
    def fake_graph(graph, pool=None):
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    calls = []
    out = torch.zeros(3)

    def step():                       # a decode step's wrapper launches
        calls.append(1)
        fused_rmsnorm.launches += 61
        decode_attention.launches += 30
        return out

    ops.reset_launch_counts()
    decode_attention.launches = 7                # launches made before
    captured = graphs.capture(step, pool="pool")
    assert len(calls) == graphs.WARMUP + 1 and pools == ["pool"]
    assert captured.out is out
    assert captured.launches["fused_rmsnorm"] == 61
    assert captured.launches["decode_attention"] == 30
    assert ops.launch_counts()["fused_rmsnorm"] == 0
    assert ops.launch_counts()["decode_attention"] == 7
    for _ in range(5):
        assert captured.replay() is out
    assert captured.graph.replays == 5 and len(calls) == graphs.WARMUP + 1
    assert ops.launch_counts()["fused_rmsnorm"] == 5 * 61
    assert ops.launch_counts()["decode_attention"] == 7 + 5 * 30
    assert sum(ops.launch_counts().values()) == 7 + 5 * 91
    ops.reset_launch_counts()
