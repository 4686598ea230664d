"""Straggler detection and mesh choices (own copies of
``repro.distributed.elastic``'s ``StepWatchdog`` and ``viable_meshes``).

``ElasticRunner``, which re-lowers a step over a JAX device mesh, waits
for the sharding slice (ROADMAP.md); on one card there is no mesh to
rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StepWatchdog:
    """Step times beyond mean + ``factor`` std (and 1.5x the mean) of the
    last 64 are stragglers."""
    factor: float = 5.0
    min_samples: int = 5
    times: list = field(default_factory=list)

    def record(self, dt: float) -> bool:
        """Returns True if ``dt`` is a straggler step."""
        if len(self.times) >= self.min_samples:
            mu = float(np.mean(self.times))
            sd = float(np.std(self.times)) + 1e-9
            if dt > mu + self.factor * sd and dt > 1.5 * mu:
                return True
        self.times.append(dt)
        if len(self.times) > 64:
            self.times.pop(0)
        return False


def viable_meshes(n_devices: int) -> list[tuple[int, int]]:
    """(data, model) factorizations, biggest model-parallel first."""
    out = []
    for model in range(min(n_devices, 64), 0, -1):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out
