"""The plain reference against the program's own plain path (its CPU
route, float32) at the smoke widths: prefill and decode logits, the MoE
layer with tokens dropped past an expert's capacity, and the scheduler's
replay against the engine on a submission log."""
from __future__ import annotations

import random

import pytest
import torch

from cardbench import reference
from cardbench.harness import ROOT, load_cell, model_dims, program_config
from cardbench import weights
from cardbench.weights import Weights
from conftest import smoke_port

CELLS = ("deepseek-7b.conv.closed", "granite-moe-3b-a800m.conv.closed")
#: f32 agreement; the program rounds the expert activations to bf16 in
#: every compute dtype (as JAX does), which moves logits ~1e-3
TOL = {CELLS[0]: 2e-4, CELLS[1]: 4e-3}


def setup(cell_name, dtype=torch.float32, **over):
    from repro_torch.models import LM
    cell = load_cell(cell_name, ROOT)
    port = dict(smoke_port(cell), **over)
    cfg = program_config(cell, port)
    specs = {n: (tuple(p.shape), p.dtype) for n, p in
             LM(cfg, device="meta", dtype=dtype).named_parameters()}
    params = Weights(specs, "cpu", dtype=dtype).draw(5)
    return cell, cfg, params, model_dims(cell.config, port)


@pytest.mark.parametrize("name", CELLS)
def test_prefill_and_decode_logits(name, monkeypatch):
    """The formulas, held at queries and keys of std 1/sqrt(fan in): at the
    cells' ``QK`` the program's bf16 expert activations, amplified by the
    sharper attention, move granite's f32 logits up to 6.1e-3."""
    from repro_torch.kernels import plain
    from repro_torch.models import LM
    monkeypatch.setattr(weights, "QK", 1.0)
    cell, cfg, params, m = setup(name)
    lm = LM.from_params(cfg, params, kernels=plain)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=g)
    with torch.no_grad():
        logits, cache = lm.prefill(tokens[:, :30], 64)
        got = [logits[0, -1]]
        for p in range(30, 40):
            logits, cache = lm.decode_step(tokens[:, p], cache,
                                           torch.tensor([p]))
            got.append(logits[0, -1])
    want = reference.logits(params, m, tokens[0], list(range(29, 40)))
    torch.testing.assert_close(torch.stack(got), want, atol=TOL[name],
                               rtol=TOL[name])


def test_moe_capacity_drops_as_the_program_does():
    from repro_torch.kernels import plain
    from repro_torch.models import LM, layers
    cell, cfg, params, m = setup(CELLS[1], capacity_factor=0.5)
    lm = LM.from_params(cfg, params, kernels=plain)
    tokens = torch.randint(0, cfg.vocab, (1, 48),
                           generator=torch.Generator().manual_seed(4))
    assert layers.capacity(cfg, 48) == reference.capacity(m, 48) == 12
    # half the assignments find no slot: the drops decide the logits
    with torch.no_grad():
        want = lm.prefill(tokens, 64)[0][0, -1]
    got = reference.logits(params, m, tokens[0], [47])[0]
    torch.testing.assert_close(got, want, atol=TOL[CELLS[1]],
                               rtol=TOL[CELLS[1]])
    m_dropless = dict(m, capacity_factor=100.0)
    other = reference.logits(params, m_dropless, tokens[0], [47])[0]
    assert (other - want).abs().max() > 1e-2


def test_fp8_control_rounds_every_product():
    cell, cfg, params, m = setup(CELLS[0])
    tokens = torch.randint(0, cfg.vocab, (24,),
                           generator=torch.Generator().manual_seed(6))
    exact = reference.logits(params, m, tokens, list(range(24)))
    low = reference.logits(params, m, tokens, list(range(24)), "fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.5


@pytest.mark.parametrize("name", CELLS)
def test_replay_matches_the_engine(name):
    from repro_torch.serving.engine import LiveRequest, ServingEngine
    cell, cfg, params, m = setup(name, dtype=torch.bfloat16)
    conf = cell.config
    eng = ServingEngine(cfg, params, device="cpu",
                        **dict(conf["engine"], max_len=256))
    rng = random.Random(1)
    log, reqs, rid = [], {}, 0
    for tick in range(400):
        if rng.random() < 0.08:
            need = rng.choice((2, 3, 9, 40, 90))
            S = rng.randint(4, 60)
            reqs[rid] = LiveRequest(rid, eng.now_ms,
                                    torch.randint(0, cfg.vocab, (1, S)),
                                    need)
            eng.submit(reqs[rid])
            log.append((tick, rid, need))
            rid += 1
        eng.step()
    got = {r: (x.first_run_ms, x.completion_ms, x.preemptions,
               len(x.generated)) for r, x in reqs.items()}
    want = reference.replay(log, 400, m, dict(conf["engine"], max_len=256),
                            conf["scheduler_model"])
    assert got == want
    assert sum(x.preemptions for x in reqs.values()) > 0
    assert sum(x.completion_ms is not None for x in reqs.values()) > 5
