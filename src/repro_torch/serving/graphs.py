"""Static slot state of the serving engine and its captured decode step.

Counterpart of the JAX engine's ``jax.jit(self.lm.decode_step)``
(``repro.serving.engine``, ``:82``). A CUDA graph replays fixed device
addresses, so the state a decode step reads and writes stays in its
slot: each of the engine's lanes owns one cache in the family's layout
(``LM.new_cache``) and a static ``token`` and ``pos`` of one row.

* Admission prefills the request straight into its slot's cache
  (``LM.prefill(..., cache=)``).
* Preemption copies the slot's cache out into storage the request owns
  (:meth:`SlotDecoder.save`); a restore copies it into the cache of the
  slot that takes the request (:meth:`SlotDecoder.load`), which may be
  another one. These copies are the device work that the modelled swap
  penalty bills.
* On the card, ``LM.decode_step`` on each slot's buffers is captured once
  per slot, when the decoder is built, into one CUDA graph; all of them
  share one memory pool, and their replays run one after the other on
  one stream, never at once. A step writes the slot's token and position
  in place and replays the graph; the logits are the graph's static
  output. On the CPU the same slot code calls ``LM.decode_step`` on the
  same buffers.

A failed capture or replay raises: nothing falls back to the eager step.
The kernel wrappers count launches on the host, which a replay does not
run, so each graph keeps the launches of its capture and adds them to the
totals at every replay; warm-up and capture calls are left out of them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels import ops
from ..models import LM

#: eager calls on a side stream before a capture (lazy kernel builds,
#: cuBLAS workspaces, allocator pools), as PyTorch's CUDA-graph notes do
WARMUP = 3


class CapturedStep:
    """One captured CUDA graph, its static output and the kernel launches
    that one replay of it makes."""

    def __init__(self, graph, out: torch.Tensor, launches: dict[str, int]):
        self.graph = graph
        self.out = out
        self.launches = launches

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.out


def capture(fn: Callable[[], torch.Tensor], *, pool=None,
            graph: Optional[torch.cuda.CUDAGraph] = None) -> CapturedStep:
    """Warms ``fn`` up on a side stream, then captures one call of it into
    ``graph`` (default: a new ``torch.cuda.CUDAGraph``) from ``pool``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with ops.uncounted(), torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph() if graph is None else graph
    with ops.uncounted() as launches, torch.cuda.graph(graph, pool=pool):
        out = fn()
    return CapturedStep(graph, out, launches)


class SlotDecoder:
    """``n_slots`` lanes of one-row decode state for ``lm``, with caches
    of ``max_len`` positions, and on the card one captured decode step a
    lane."""

    @torch.inference_mode()
    def __init__(self, lm: LM, n_slots: int, max_len: int):
        self.lm = lm
        self.max_len = max_len
        dev = lm.device
        self.caches = [lm.new_cache(1, max_len) for _ in range(n_slots)]
        self.tokens = [torch.zeros(1, dtype=torch.int64, device=dev)
                       for _ in range(n_slots)]
        self.pos = [torch.zeros(1, dtype=torch.int64, device=dev)
                    for _ in range(n_slots)]
        self.graphs: list[Optional[CapturedStep]] = [None] * n_slots
        if dev.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            self.graphs = [capture(lambda i=i: self.eager_step(i), pool=pool)
                           for i in range(n_slots)]

    def eager_step(self, i: int) -> torch.Tensor:
        """``LM.decode_step`` on slot ``i``'s buffers: the captured call,
        and the step itself on the CPU."""
        return self.lm.decode_step(self.tokens[i], self.caches[i],
                                   self.pos[i])[0]

    @torch.inference_mode()
    def prefill(self, i: int, tokens: torch.Tensor) -> torch.Tensor:
        """Prefills a (1, S) prompt into slot ``i``'s cache; returns the
        last token's logits (1, 1, V)."""
        return self.lm.prefill(tokens, self.max_len, cache=self.caches[i])[0]

    @torch.inference_mode()
    def save(self, i: int) -> dict:
        """A copy of slot ``i``'s state, for the request that leaves it."""
        return {n: t.clone() for n, t in self.caches[i].items()}

    @torch.inference_mode()
    def load(self, i: int, state: dict) -> None:
        """Copies a request's saved ``state`` into slot ``i``'s cache."""
        for n, t in self.caches[i].items():
            t.copy_(state[n])

    @torch.inference_mode()
    def step(self, i: int, token: int, pos: int) -> torch.Tensor:
        """Decodes ``token`` at position ``pos`` in slot ``i``; returns the
        logits (1, 1, V), which the next step of the slot overwrites on
        the card."""
        self.tokens[i].fill_(token)
        self.pos[i].fill_(pos)
        graph = self.graphs[i]
        return self.eager_step(i) if graph is None else graph.replay()
