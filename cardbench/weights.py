"""The model's weights, drawn by the benchmark from ``--seed`` on the
device, in two large calls: one standard-normal draw into a flat buffer
of the served dtype for the matmul weights and one into a float32 buffer
for the rest (the port keeps its embedding, head and norm weights in
float32), each leaf then a view of its buffer scaled in place.

The same tensors go to the program (``ServingEngine``) and to the plain
reference (:mod:`cardbench.reference`). Scales: a matmul weight's std is
1/sqrt(fan in), the router's ``ROUTER`` times that, the query and key
projections' ``QK`` times that; the embedding and
head rows 1/sqrt(hidden); the layers' norm weights 0.1 N(0, 1) around the
port's (1 + w), the final norm's (1 + w) drawn N(0, 1): a gain of either
sign on each dimension, so that where the head is the embedding table
(granite) the served token is not the echo of the one fed, which
otherwise outscores every other at every step.
"""
from __future__ import annotations

import math

import torch

#: the router's std over 1/sqrt(fan in): router logits of std ROUTER, so
#: that the gates are peaked (the first of eight about half the weight),
#: and the eighth and ninth experts, whose order rounding flips, carry
#: little of it
ROUTER = 3.0
#: the query and key projections' std over 1/sqrt(fan in): scores
#: q.k / sqrt(head_dim) of std QK**2 (about 2.25), so that a head attends
#: to a few of a thousand keys, as trained heads do, and what a lane's
#: cache holds decides the served tokens. At 1.0 the scores' std is 1,
#: attention over a prompt of ~1,000 random tokens is near uniform, and a
#: decode step that leaves the cache unchanged moved deepseek-7b's widest
#: gap to 0.09-0.16 only (sound runs 0.04-0.09); at 2.0 thirty layers in
#: bfloat16 part from the float32 reference by rounding alone
QK = 1.5


def leaf_init(name: str, shape: tuple) -> tuple[float, float]:
    """(mean, std) of a leaf's normal draw."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "norm":
        return 0.0, 0.1
    if name == "final_norm":
        return -1.0, 1.0
    if name in ("embed", "lm_head"):
        return 0.0, 1.0 / math.sqrt(shape[1] if name == "embed"
                                    else shape[0])
    std = 1.0 / math.sqrt(shape[-2])
    return 0.0, std * {"router": ROUTER, "wq": QK, "wk": QK}.get(leaf, 1.0)


def layout(specs: dict, dtype: torch.dtype) -> tuple[dict, int, int]:
    """(name -> (buffer, offset, shape), elements of the matmul buffer, of
    the f32 buffer) for ``specs`` name -> (shape, dtype)."""
    at, n = {}, {dtype: 0, torch.float32: 0}
    for name, (shape, dt) in specs.items():
        at[name] = (dt, n[dt], tuple(shape))
        n[dt] += math.prod(shape)
    return at, n[dtype], n[torch.float32]


class Weights:
    """The parameter dict of ``specs`` (name -> (shape, dtype)) as views of
    two flat buffers on ``device``; :meth:`draw` refills them in place."""

    def __init__(self, specs: dict, device,
                 dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        self.dtype = dtype
        at, n_mm, n_f32 = layout(specs, dtype)
        self.flat = {dtype: torch.empty(n_mm, dtype=dtype,
                                        device=self.device),
                     torch.float32: torch.empty(n_f32, dtype=torch.float32,
                                                device=self.device)}
        self.params = {}
        self.init = {}
        for name, (dt, off, shape) in at.items():
            self.params[name] = self.flat[dt][off:off + math.prod(shape)] \
                .view(shape)
            self.init[name] = leaf_init(name, shape)

    def draw(self, seed: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for buf in self.flat.values():
            buf.normal_(generator=gen)
        with torch.no_grad():
            for name, t in self.params.items():
                mean, std = self.init[name]
                t.mul_(std).add_(mean)
        return self.params

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.flat.values())
