"""Whether what the timed path produced is correct, judged after the
window against the plain reference (:mod:`cardbench.reference`), which
works everything out again from the benchmark's own inputs: the weights
it drew, the prompts it sent and the submissions it logged.

* ``logit_gap`` and ``logit_gap_mean``: a sample of the requests the
  engine finished in the window, drawn from the seed: the one with the
  most served tokens, one restored into another lane after a swap where
  any finished, and others until ``TARGET_TOKENS`` served tokens (at
  most ``MAX_REF_TOKENS`` positions for the reference to run). The
  reference runs each prompt with its served tokens once, in float32;
  each served token's gap is how far its logit lies below the
  reference's best at its position; the numbers are the widest gap and
  the mean. Prefill into a FIFO lane, the graphed decode steps (the MoE
  layer's too) and the state restored after a swap all feed them.
* ``sched_mismatch``: the requests whose first run, completion (modelled
  ms), preemptions or tokens made differ from the reference scheduler's
  replay of the run's own submission log. Exact: limit 0.

A configuration's ``limits`` name the numbers its cells compare, each
with its limit.
"""
from __future__ import annotations

import random

import torch

from . import reference
from .harness import seed_of

TARGET_TOKENS, MAX_REF_TOKENS = 256, 32768


def sample(rec, programs: dict) -> list:
    rng = random.Random(seed_of(rec.seed, 3))
    done = sorted((rid for rid, live in programs.items()
                   if live.completion_ms is not None),
                  key=lambda rid: (-len(programs[rid].generated), rid))
    if not done:
        return []
    pick = [done[0]]
    moved = [rid for rid in done[1:] if len(set(rec.reqs[rid].lanes)) > 1]
    if moved:
        pick.append(rng.choice(moved))
    rest = done[1:]
    rng.shuffle(rest)

    def size(rid):
        return rec.reqs[rid].prompt + len(programs[rid].generated) - 1

    for rid in rest:
        served = sum(len(programs[r].generated) for r in pick)
        if served >= TARGET_TOKENS:
            break
        if rid not in pick and sum(map(size, pick)) + size(rid) \
                <= MAX_REF_TOKENS:
            pick.append(rid)
    return pick


def served_logits(params: dict, m: dict, prompt: torch.Tensor, served: list,
                  precision: str = "f32") -> torch.Tensor:
    """The reference's logits (n, V) at the positions where the n served
    tokens were chosen: the prompt with all but the last served token
    fed, as the engine fed them."""
    S = prompt.shape[-1]
    dev = params["embed"].device
    seq = torch.cat([prompt.reshape(-1).to(dev),
                     torch.tensor(served[:-1], dtype=torch.int64,
                                  device=dev)])
    return reference.logits(params, m, seq,
                            list(range(S - 1, S - 1 + len(served))),
                            precision, prompt=S)


def gap(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best of its row."""
    return ref.max(-1).values - ref.gather(
        1, tokens.to(ref.device)[:, None])[:, 0]


def gaps(rec, programs: dict, params: dict, prompts: list,
         control: bool = False) -> tuple[list, list, list]:
    """(the served tokens' gaps, a tensor a request, and with ``control``
    the gaps of the float8 reference's first choices at the same
    positions, or None; the requests sampled)."""
    picked = sample(rec, programs)
    out, low = [], []
    for rid in picked:
        served = programs[rid].generated
        ref = served_logits(params, rec.m, prompts[rid], served)
        out.append(gap(ref, torch.tensor(served)))
        if control:
            first = served_logits(params, rec.m, prompts[rid], served,
                                  "fp8").argmax(-1)
            low.append(gap(ref, first))
    cpu = (lambda v: [t.cpu() for t in v])
    return cpu(out), (cpu(low) if control else None), picked


def numbers(per_request: list) -> dict:
    """The numbers a check can compare, of the served tokens' gaps (a
    tensor a request): the widest gap, the mean gap, and the mean gap of
    the request whose mean is widest (a fault in one lane's state shows
    there undiluted by the other requests)."""
    if not per_request:
        return {"logit_gap": None, "logit_gap_mean": None,
                "logit_gap_req_mean": None}
    g = torch.cat(per_request)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "logit_gap_req_mean": max(float(t.mean()) for t in per_request)}


def n_tokens(per_request: list) -> int:
    return sum(t.numel() for t in per_request)


def mismatch(rec, programs: dict) -> int:
    """The requests whose scheduling differs from the reference's replay
    of the run's own submission log."""
    conf = rec.cell.config
    replayed = reference.replay(rec.submissions, rec.ticks, rec.m,
                                conf["engine"], conf["scheduler_model"])
    return sum(1 for rid, live in programs.items()
               if (live.first_run_ms, live.completion_ms, live.preemptions,
                   len(live.generated)) != replayed.get(rid))


def run(rec, programs: dict, params: dict, prompts: list) -> dict:
    """Each number the configuration's ``limits`` names, beside its limit,
    and ``sched_mismatch``."""
    conf = rec.cell.config
    g, _, picked = gaps(rec, programs, params, prompts)
    got = numbers(g)
    out = {name: {"value": got[name], "limit": limit,
                  "requests": len(picked), "tokens": n_tokens(g)}
           for name, limit in conf["limits"].items()}
    out["sched_mismatch"] = {"value": mismatch(rec, programs), "limit": 0,
                             "requests": len(programs)}
    return out
