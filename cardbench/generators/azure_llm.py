"""The request stream of a traffic mix: lengths and arrivals drawn from a
mix's parameters and ``--seed``.

Lengths follow the Azure LLM inference traces (github.com/Azure/
AzurePublicDataset, the 2023 code and conversation traces, as
characterised in Splitwise, arXiv:2311.18677): log-normal prompt and
output lengths at the mix's medians and spreads. Every seed gets the same
set of ``n_requests`` sizes, the log-normal's quantiles at (i + 1/2) / n,
and the same set of gaps, the exponential's quantiles at the mix's rate,
each set in an order of the seed's own, so that seeds change which
request comes when and not how much work there is. ``order`` is
``"random"`` (a uniform permutation: the gaps of a Poisson process) or
``"low_discrepancy"`` (the bit-reversed order, rotated by the seed: every
run of consecutive requests is an even sample of the distribution).
``order_seed``, where a mix gives one, draws the order in place of the
seed: every seed then serves the same requests in the same order, and
draws only their tokens and the weights. A window that holds a few dozen
requests of a heavy tail needs it: which long requests fall in the
window would otherwise set the work of a run.

``arrivals`` is ``{"kind": "open", "rate_per_s": r}``, requests due at
the cumulative gaps, or ``{"kind": "closed", "clients": k}``, k clients
each sending its next request when the last one completes. A prompt and
its output together fit the context: ``prompt + output - 1 <= context``
(the output clipped first to ``max_output``, then the prompt).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Stream:
    prompt: list            # tokens a request's prompt
    output: list            # tokens it asks for
    due_s: Optional[list]   # open loop: offset from the window's start
    clients: Optional[int]  # closed loop


def quantiles(n: int, median: float, sigma: float, lo: int) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.maximum(np.round(median * np.exp(sigma * z)), lo).astype(int)


def bit_reversed(n: int) -> np.ndarray:
    bits = max(1, (n - 1).bit_length())
    return np.array(sorted(range(n), key=lambda i: int(
        format(i, f"0{bits}b")[::-1], 2)))


def ordered(values: np.ndarray, order: str, rng: np.random.Generator
            ) -> np.ndarray:
    if order == "random":
        return values[rng.permutation(len(values))]
    if order == "low_discrepancy":
        return values[np.roll(bit_reversed(len(values)),
                              int(rng.integers(len(values))))]
    raise ValueError(f"unknown order {order!r}")


def make(mix: dict, seed: int) -> Stream:
    n = int(mix["n_requests"])
    rng = np.random.default_rng(mix.get("order_seed", seed))
    p, o = mix["prompt"], mix["output"]
    out = ordered(quantiles(n, o["median"], o["sigma"], o["min"]),
                  mix["order"], rng)
    out = np.minimum(out, mix["max_output"])
    prompt = ordered(quantiles(n, p["median"], p["sigma"], p["min"]),
                     mix["order"], rng)
    prompt = np.minimum(prompt, mix["context"] + 1 - out)
    arr = mix["arrivals"]
    due = clients = None
    if arr["kind"] == "open":
        gaps = np.array([-math.log1p(-(i + 0.5) / n) for i in range(n)]) \
            / arr["rate_per_s"]
        due = np.cumsum(ordered(gaps, mix["order"], rng)).tolist()
    elif arr["kind"] == "closed":
        clients = int(arr["clients"])
    else:
        raise ValueError(f"unknown arrivals {arr['kind']!r}")
    return Stream(prompt.tolist(), out.tolist(), due, clients)
