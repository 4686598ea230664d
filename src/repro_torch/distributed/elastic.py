"""Straggler detection, mesh choices and the re-mesh loop (counterpart
of ``repro.distributed.elastic``: ``StepWatchdog``, ``viable_meshes`` and
``ElasticRunner``).

Device loss shows up as a failed collective; the recovery path is:
checkpoint-restore, build a smaller or larger mesh, build the step again.
``ElasticRunner`` packages the last two. On one card its mesh is 1 x 1
and the step is built once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .sharding import Mesh, use_mesh


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


class ElasticRunner:
    """Re-mesh and rebuild the step when the device count changes the
    mesh's shape. ``build_step(ctx)`` gets the ``ShardingCtx`` of the new
    mesh (installed with ``use_mesh`` while it runs) and returns the step
    function."""

    def __init__(self, build_step: Callable):
        self.build_step = build_step
        self.step_fn = None
        self.mesh: Optional[Mesh] = None

    def ensure(self, devices: Optional[Sequence[torch.device]] = None):
        """The step for ``devices`` (default: every CUDA device), on the
        (data, model) mesh of ``viable_meshes(len(devices))[-1]``; built
        again only where that mesh's shape differs from the last one."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        from ..launch.mesh import make_mesh   # launch.mesh imports this package
        mesh = make_mesh(*viable_meshes(len(devices))[-1], devices)
        if self.mesh is not None and mesh.shape == self.mesh.shape:
            return self.step_fn
        self.mesh = mesh
        with use_mesh(mesh) as ctx:
            self.step_fn = self.build_step(ctx)
        return self.step_fn
