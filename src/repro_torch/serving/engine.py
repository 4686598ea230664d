"""Real-model serving engine of the port: per-slot decode with real KV
caches under the paper's hybrid slot scheduler.

Counterpart of ``repro.serving.engine`` (``:30-173``), with the same
scheduling code line for line: a FIFO group of slots runs requests to
completion unless they exceed the adapted time limit, in which case
they move to the fair-share group and pay the modelled KV swap penalty
in simulated wall-clock. Scheduling depends only on token counts, so on
the same model and prompts both engines make the same decisions.

Where the JAX engine jits its decode step, this one replays it
(:mod:`.graphs`): each slot owns a preallocated cache and static token
and position buffers, and on the card one CUDA graph of
``LM.decode_step`` on them, captured when the engine is built. A request
is prefilled into the cache of the slot that admits it. Preemption copies
the slot's state out into ``req.cache``, and a restore copies it into
the cache of the slot that takes the request back, which may be another
one. On the CPU the same slots run ``LM.decode_step`` eagerly. Greedy
decoding takes the first maximum, as ``jnp.argmax`` does. Prompts are
int64 tensors on the engine's device.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..core.hybrid import TimeLimitAdapter
from ..costmodel.pricing import DEFAULT_PRICING
from ..device import resolve_device
from ..models import LM
from .graphs import SlotDecoder
from .request import preemption_penalty_ms


@dataclass
class LiveRequest:
    rid: int
    arrival_ms: float
    tokens: Any                       # prompt token array (1, S)
    max_new: int
    mem_gb: float = 0.5
    # runtime
    generated: list = field(default_factory=list)
    cache: Any = None                 # its state while swapped out
    pos: int = 0
    cpu_ms: float = 0.0               # accumulated slot time
    vruntime: float = 0.0
    first_run_ms: Optional[float] = None
    completion_ms: Optional[float] = None
    preemptions: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    def execution_ms(self) -> float:
        return self.completion_ms - self.first_run_ms

    def cost_usd(self) -> float:
        return (self.execution_ms() / 1000.0 * self.mem_gb
                * DEFAULT_PRICING.price_per_gb_second
                + DEFAULT_PRICING.price_per_request)


class ServingEngine:
    """``params`` is a parameter dict of :mod:`repro_torch.params`; it must
    lie on ``device`` (default: the card, which must exist)."""

    def __init__(self, cfg: ModelConfig, params: dict, *, n_slots: int = 4,
                 n_fifo: int = 2, max_len: int = 128,
                 adapt_pct: float = 95.0, initial_limit_ms: float = 200.0,
                 fair_slice_steps: int = 4,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lm = LM.from_params(cfg, params)
        if self.lm.device.type != self.device.type:
            raise ValueError(f"parameters are on {self.lm.device}, the "
                             f"engine runs on {self.device}")
        self.n_slots = n_slots
        self.n_fifo = n_fifo
        self.max_len = max_len
        self.adapter = TimeLimitAdapter(pct=adapt_pct,
                                        initial_ms=initial_limit_ms)
        self.fair_slice_steps = fair_slice_steps
        self.step_ms = cfg.ms_per_token_decode
        self.penalty_ms = preemption_penalty_ms(cfg, max_len)
        self.pending: deque[LiveRequest] = deque()
        self.fair_queue: list[LiveRequest] = []
        self.slots: list[Optional[LiveRequest]] = [None] * n_slots
        self.slot_ready_ms = [0.0] * n_slots      # swap-penalty stalls
        self.completed: list[LiveRequest] = []
        self.now_ms = 0.0
        self.decoder = SlotDecoder(self.lm, n_slots, max_len)

    # -- model ops ------------------------------------------------------
    def _prefill(self, i: int, req: LiveRequest):
        logits = self.decoder.prefill(i, req.tokens)
        req.pos = req.tokens.shape[1]
        req.generated.append(int(torch.argmax(logits[0, -1])))

    def _decode_one(self, i: int, req: LiveRequest):
        logits = self.decoder.step(i, req.generated[-1], req.pos)
        req.pos += 1
        req.generated.append(int(torch.argmax(logits[0, -1])))

    def _swap_out(self, i: int, req: LiveRequest):
        req.cache = self.decoder.save(i)

    def _swap_in(self, i: int, req: LiveRequest):
        self.decoder.load(i, req.cache)
        req.cache = None

    # -- scheduler ------------------------------------------------------
    def submit(self, req: LiveRequest):
        req.tokens = torch.as_tensor(req.tokens, dtype=torch.int64,
                                     device=self.lm.device)
        if req.tokens.dim() != 2 or req.tokens.shape[0] != 1:
            raise ValueError(f"request {req.rid}: prompt must be (1, S), "
                             f"got {tuple(req.tokens.shape)}")
        # prefill fills S cache slots and each decode step but the last
        # writes one more; past max_len the in-place write would index
        # outside the cache
        if req.tokens.shape[1] + req.max_new - 1 > self.max_len:
            raise ValueError(f"request {req.rid}: {req.tokens.shape[1]} "
                             f"prompt + {req.max_new} new tokens exceed "
                             f"max_len {self.max_len}")
        self.pending.append(req)

    def _admit(self):
        for i in range(self.n_fifo):
            if self.slots[i] is None and self.pending \
                    and self.now_ms >= self.slot_ready_ms[i]:
                req = self.pending.popleft()
                if req.arrival_ms > self.now_ms:
                    self.pending.appendleft(req)
                    break
                req.first_run_ms = (self.now_ms if req.first_run_ms is None
                                    else req.first_run_ms)
                self._prefill(i, req)
                self.slots[i] = req
        # fair slots pick min-vruntime from the fair queue
        for i in range(self.n_fifo, self.n_slots):
            if self.slots[i] is None and self.fair_queue \
                    and self.now_ms >= self.slot_ready_ms[i]:
                self.fair_queue.sort(key=lambda r: r.vruntime)
                req = self.fair_queue.pop(0)
                # restore costs the swap penalty (stall the slot)
                self.slot_ready_ms[i] = self.now_ms + self.penalty_ms
                self._swap_in(i, req)
                self.slots[i] = req

    def _complete(self, i: int):
        req = self.slots[i]
        req.completion_ms = self.now_ms
        self.adapter.record(req.execution_ms(), self.now_ms)
        self.completed.append(req)
        self.slots[i] = None

    def step(self):
        """One engine tick = one decode step per busy, unstalled slot."""
        self._admit()
        self.now_ms += self.step_ms
        limit = self.adapter.limit()
        for i in range(self.n_slots):
            req = self.slots[i]
            if req is None or self.now_ms < self.slot_ready_ms[i]:
                continue
            self._decode_one(i, req)
            req.cpu_ms += self.step_ms
            req.vruntime += self.step_ms
            if req.done:
                self._complete(i)
                continue
            if i < self.n_fifo and req.cpu_ms > limit:
                # paper's core move: over-limit requests leave the
                # run-to-completion group; eviction = KV swap penalty
                req.preemptions += 1
                self._swap_out(i, req)
                self.fair_queue.append(req)
                self.slots[i] = None
                self.slot_ready_ms[i] = self.now_ms + self.penalty_ms
            elif i >= self.n_fifo and \
                    req.cpu_ms % (self.fair_slice_steps * self.step_ms) \
                    < self.step_ms and (self.fair_queue):
                # fair-share slice expiry: rotate if someone is waiting
                req.preemptions += 1
                self._swap_out(i, req)
                self.fair_queue.append(req)
                self.slots[i] = None
                self.slot_ready_ms[i] = self.now_ms + self.penalty_ms

    def run(self, max_steps: int = 100_000):
        steps = 0
        while (self.pending or self.fair_queue
               or any(s is not None for s in self.slots)):
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError("engine did not drain")
        return self.completed
