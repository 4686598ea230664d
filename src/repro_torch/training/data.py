"""Deterministic, resumable synthetic token pipeline (own copy of
``repro.training.data``).

The batches are JAX's, drawn by the same numpy generator from
``SeedSequence([seed, step])``; only the outputs become torch tensors
(int32, as JAX's) on the caller's device. State = (seed, step), so a
restart resumes the exact batch sequence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch


@dataclass
class SyntheticLM:
    """Zipf-distributed token stream with a repeating motif (every 8th
    position repeats position 0), so the loss decreases."""
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    step: int = 0
    device: Optional[Union[str, torch.device]] = "cpu"

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step]))
        self.step += 1
        ranks = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(ranks, self.vocab - 1).astype(np.int32)
        toks[:, ::8] = toks[:, :1]
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])
