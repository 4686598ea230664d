"""Run a grid of batched Monte-Carlo cells (counterpart of
``repro.mc.kernels.run_grid``, ``src/repro/mc/kernels.py:762``).

A cell is one (policy, trace) trajectory of the single-node scheduler in
the supported regime: single node, no container pool, policies ``fifo``,
``cfs`` and ``hybrid`` with a static time limit, and the default Linux
knobs below. A plain-FIFO cell is the hybrid machinery with ``n_fifo ==
C`` and an infinite budget; a pure-CFS cell is ``n_fifo == 0``. On the
card the grid is one launch of ``csrc/mc_cell.cu``; on the CPU the plain
PyTorch version runs it. Either way the outputs equal the scalar
engine's, bit for bit, and ``n_events`` agrees between the two.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.mc_cell import (CTX_SWITCH_MS, MIN_GRANULARITY_MS,
                               SCHED_LATENCY_MS, mc_cell_cuda, run_grid_plain)

__all__ = ["CTX_SWITCH_MS", "MIN_GRANULARITY_MS", "SCHED_LATENCY_MS",
           "run_grid"]


def run_grid(arrival, service, n_tasks, n_fifo, limit, *, n_cores: int,
             device: Optional[Union[str, torch.device]] = None) -> dict:
    """Advance a whole grid of cells; returns the outputs as NumPy.

    arrival, service : f64[B, N]  (padding past ``n_tasks`` is ignored)
    n_tasks, n_fifo  : i32[B]     (``n_fifo``: C plain FIFO, 0 pure CFS)
    limit            : f64[B]     (the hybrid's time limit; inf otherwise)

    Returns ``completion``, ``first_run``, ``cpu_time`` (f64[B, N], NaN /
    0 in padded slots), ``preemptions``, ``ctx_switches``, ``migrations``
    (i32[B, N]), ``ok`` (bool[B]: every live task finished within the
    event cap), ``n_iters`` (the implementation's own loop trips) and
    ``n_events`` (scheduling events). ``device=None`` is the card; the
    CPU runs the plain version.
    """
    dev = resolve_device(device)
    arrival = np.asarray(arrival, np.float64)
    service = np.asarray(service, np.float64)
    n_tasks = np.asarray(n_tasks, np.int32)
    n_fifo = np.asarray(n_fifo, np.int32)
    limit = np.asarray(limit, np.float64)
    B, N = arrival.shape
    if service.shape != (B, N) or any(a.shape != (B,) for a in
                                      (n_tasks, n_fifo, limit)):
        raise ValueError("run_grid: arrival/service must be (B, N) and "
                         "n_tasks/n_fifo/limit (B,)")
    live = np.arange(N)[None, :] < n_tasks[:, None]
    if np.any((n_tasks < 0) | (n_tasks > N)):
        raise ValueError("run_grid: n_tasks must be in [0, N]")
    if np.any((n_fifo < 0) | (n_fifo > n_cores)):
        raise ValueError(f"run_grid: n_fifo must be in [0, {n_cores}]")
    if np.any((n_fifo == n_cores) & (limit != np.inf)):
        raise ValueError("run_grid: a plain-FIFO cell (n_fifo == n_cores) "
                         "needs an infinite limit")
    if not np.all(np.isfinite(arrival[live]) & np.isfinite(service[live])
                  & (service[live] >= 0.0)):
        raise ValueError("run_grid: live arrivals and services must be "
                         "finite, services non-negative")
    if np.any(live[:, 1:] & (arrival[:, 1:] < arrival[:, :-1])):
        raise ValueError("run_grid: arrivals must be non-decreasing")

    args = [torch.from_numpy(a).to(dev) for a in
            (arrival, service, n_tasks, n_fifo, limit)]
    fn = mc_cell_cuda if dev.type == "cuda" else run_grid_plain
    out = fn(*args, n_cores=n_cores)
    return {k: v.cpu().numpy() for k, v in out.items()}
