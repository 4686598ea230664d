"""High-level entry point: run a named policy over a workload (own copy
of ``repro.core.simulate``).

The microVM mode (paper Sec. VI-E, Fig. 21/22) models Firecracker:
per-invocation boot overhead, auxiliary VMM threads scheduled under the
same policy, a per-instance memory footprint, and admission failure when
the host memory is exhausted (the paper could launch at most 2,952
microVMs on a 512 GB box).
"""
from __future__ import annotations

import copy
import warnings
from typing import Optional

from .containers import ContainerConfig, ContainerPool
from .events import Scheduler, Task
from .hybrid import HybridScheduler, Rightsizer, TimeLimitAdapter
from .metrics import SimResult, collect
from .policies import CFS, EDF, FIFO, FIFOPreempt, RoundRobin

POLICIES = {
    "fifo": FIFO,
    "fifo_preempt": FIFOPreempt,
    "rr": RoundRobin,
    "cfs": CFS,
    "edf": EDF,
    "hybrid": HybridScheduler,
}


def make_scheduler(policy: str, **kw) -> Scheduler:
    if policy not in POLICIES:
        raise KeyError(f"unknown policy {policy!r}; have {sorted(POLICIES)}")
    return POLICIES[policy](**kw)


def execute_policy(policy: str, workload: list[Task], *,
                   n_cores: int = 50,
                   adapt_pct: Optional[float] = None,
                   rightsize: bool = False,
                   microvm: bool = False,
                   ghost_mode: bool = False,
                   containers: Optional[ContainerConfig] = None,
                   fresh_tasks: bool = True,
                   **kw) -> SimResult:
    """Simulate ``policy`` over ``workload`` and aggregate results —
    the single-node execution engine.

    ``adapt_pct``/``rightsize`` only apply to the hybrid policy.
    ``ghost_mode`` enables the native-CFS spawn-storm interference model
    (DESIGN.md Sec. 8): the measured ghOSt system, not an ideal enclave.
    ``containers`` attaches the sandbox lifecycle layer (DESIGN.md
    Sec. 9): invocations take a cold/warm path through a per-node
    ``ContainerPool`` and cold starts occupy a core for their billed
    ``init_ms``. ``fresh_tasks`` deep-copies the workload so callers can
    reuse it.
    """
    tasks = copy.deepcopy(workload) if fresh_tasks else workload
    if containers is not None:
        kw.setdefault("containers", containers)
    if policy == "hybrid":
        if adapt_pct is not None:
            kw.setdefault("adapter", TimeLimitAdapter(pct=adapt_pct))
        if rightsize:
            kw.setdefault("rightsizer", Rightsizer())
    if ghost_mode:
        kw.setdefault("interference_fn",
                      spawn_storm_interference(workload, n_cores=n_cores))
    sched = make_scheduler(policy, n_cores=n_cores, **kw)
    if microvm:
        tasks = apply_microvm_model(tasks)
        tasks, failed = admit_microvm(tasks)
        sched.failed.extend(failed)
    sched.run(tasks)
    return collect(sched, policy)


def run_policy(policy: str, workload: list[Task], *,
               n_cores: int = 50,
               adapt_pct: Optional[float] = None,
               rightsize: bool = False,
               microvm: bool = False,
               ghost_mode: bool = False,
               containers: Optional[ContainerConfig] = None,
               fresh_tasks: bool = True,
               **kw) -> SimResult:
    """Deprecated: build a :class:`repro_torch.Scenario` and call
    ``repro_torch.run``. This shim routes through exactly that path, so
    its results stay bit-identical to the Scenario API."""
    warnings.warn(
        "run_policy() is deprecated; use repro_torch.run(Scenario(workload="
        "WorkloadSpec(kind='tasks', tasks=...), ...)) instead",
        DeprecationWarning, stacklevel=2)
    from ..scenario import (FleetSpec, PolicySpec, Scenario, WorkloadSpec,
                            run)
    sc = Scenario(
        workload=WorkloadSpec(kind="tasks", tasks=workload,
                              fresh=fresh_tasks),
        fleet=FleetSpec(n_nodes=1, cores_per_node=n_cores,
                        containers=containers),
        policy=PolicySpec(name=policy, adapt_pct=adapt_pct,
                          rightsize=rightsize, microvm=microvm,
                          ghost_mode=ghost_mode, kw=kw))
    return run(sc).raw


# -- ghOSt native-CFS interference model --------------------------------------
#
# ghOSt's scheduling class sits BELOW native CFS: any runnable native task
# on an enclave core starves the ghOSt task. Each invocation spawns as a
# native process and runs under native CFS until the workload generator
# pins its pid into the enclave (paper Fig. 9 step 4), so spawn storms
# steal enclave CPU. We model the stolen fraction per 1-second bin as
#   min(cap, arrivals_in_bin * pin_delay_ms / (n_cores * 1000)).

PIN_DELAY_MS = 400.0     # spawn -> enclave-pin latency under load
STEAL_CAP = 0.92


def spawn_storm_interference(workload: list[Task], n_cores: int = 50,
                             pin_delay_ms: float = PIN_DELAY_MS,
                             cap: float = STEAL_CAP):
    import numpy as np
    horizon = max(t.arrival for t in workload) + 1000.0
    nbins = int(horizon // 1000) + 2
    counts = np.zeros(nbins)
    for t in workload:
        counts[int(t.arrival // 1000)] += 1
    frac = np.minimum(cap, counts * pin_delay_ms / (n_cores * 1000.0))

    def fn(t_ms: float) -> float:
        b = int(t_ms // 1000)
        return float(frac[b]) if 0 <= b < nbins else 0.0

    return fn


# -- Firecracker microVM model (Sec. VI-E) -----------------------------------

MICROVM_BOOT_MS = 125.0          # Firecracker boot + guest kernel
MICROVM_VMM_OVERHEAD = 0.10      # VMM/vCPU emulation tax on service time
MICROVM_FOOTPRINT_MB = 170.0     # per-instance host memory footprint
HOST_MEMORY_MB = 512 * 1024.0    # the paper's 512 GB host
MICROVM_CAP = 2952               # matches the paper's observed limit


def apply_microvm_model(tasks: list[Task]) -> list[Task]:
    out = []
    for t in tasks:
        t = copy.copy(t)
        t.service = t.service * (1.0 + MICROVM_VMM_OVERHEAD) + MICROVM_BOOT_MS
        t.remaining = t.service
        out.append(t)
    return out


def admit_microvm(tasks: list[Task],
                  cap: int = MICROVM_CAP) -> tuple[list[Task], list[Task]]:
    """Admission control: instances beyond the host-memory cap fail to
    launch (horizontal line at the start of Fig. 21)."""
    admitted, failed = [], []
    for i, t in enumerate(sorted(tasks, key=lambda x: x.arrival)):
        if i < cap:
            admitted.append(t)
        else:
            t.failed = True
            failed.append(t)
    return admitted, failed
