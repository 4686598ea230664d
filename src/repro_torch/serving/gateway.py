"""FaaS-for-models gateway: the paper's hybrid two-group scheduler over
DEVICE SLOTS (decode-batch lanes) instead of CPU cores (own copy of
``repro.serving.gateway``).

Requests (= serverless functions) arrive with Azure-trace statistics;
slots are partitioned into a FIFO group (run-to-completion, no KV swaps)
and a fair-share group (vruntime time-slicing where every preemption
pays the KV offload/restore penalty — the device's context switch). The
paper's time-limit adaptation (percentile of the last 100 request
durations) and slot-group rightsizing are inherited unchanged from
repro_torch.core. Billing is wall-clock execution x per-ms-per-GB.

A straggler-mitigation hook re-dispatches requests whose execution span
exceeds ``straggler_factor`` x the expected service time (models a slow
or failed device lane — Sec. "fault tolerance" in DESIGN.md).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..configs.base import ModelConfig
from ..core.containers import ContainerConfig, as_container_config
from ..core.events import Task
from ..core.hybrid import HybridScheduler, Rightsizer, TimeLimitAdapter
from ..core.metrics import SimResult
from ..core.policies import CFS, FIFO
from ..costmodel.pricing import DEFAULT_PRICING
from ..traces.azure import TraceSpec
from ..traces.workload import generate_workload
from .request import RequestSpec, preemption_penalty_ms, service_ms


def _serving_quanta(penalty_ms: float) -> dict:
    """Fair-share quanta must dominate the KV-swap penalty or the
    fair group livelocks (every slice adds more swap work than it
    retires). Real serving engines use second-scale slices for exactly
    this reason."""
    q = max(4.0 * penalty_ms, 250.0)
    return {"sched_latency_ms": 2 * q, "min_granularity_ms": q}


class SlotHybridScheduler(HybridScheduler):
    """Hybrid scheduler whose preemptions carry the KV-swap penalty."""

    name = "slot_hybrid"
    # on_chunk_limit adds the KV-swap penalty whenever another request
    # displaces this one (non-empty runqueue): the analytic fast-forward
    # may only batch lone-task slice cycles, where the override is a
    # no-op (see HybridScheduler._ff_solo_only).
    _ff_solo_only = True

    def __init__(self, cfg: ModelConfig, seq_len: int = 4096,
                 straggler_factor: float = 0.0, **kw):
        penalty = preemption_penalty_ms(cfg, seq_len)
        kw.update(_serving_quanta(penalty))
        super().__init__(**kw)
        self.model_cfg = cfg
        self.penalty_ms = penalty
        self.straggler_factor = straggler_factor
        self.redispatches = 0

    def on_chunk_limit(self, core, task, t):
        # A preemption swaps the request's KV out and back in — but only
        # when another request actually displaces it (FIFO->CFS
        # migration always does; a fair-share slice expiry with an empty
        # queue keeps the cache resident).
        from ..core.events import GROUP_FIFO
        if core.group == GROUP_FIFO or core.rq:
            task.remaining += self.penalty_ms
        super().on_chunk_limit(core, task, t)

    def on_complete(self, task, t):
        super().on_complete(task, t)
        if (self.straggler_factor > 0
                and task.execution > self.straggler_factor * task.service):
            self.redispatches += 1


class SlotCFS(CFS):
    name = "slot_cfs"
    _ff_solo_only = True  # same contract as SlotHybridScheduler

    def __init__(self, cfg: ModelConfig, seq_len: int = 4096, **kw):
        penalty = preemption_penalty_ms(cfg, seq_len)
        kw.update(_serving_quanta(penalty))
        super().__init__(**kw)
        self.penalty_ms = penalty

    def on_chunk_limit(self, core, task, t):
        if core.rq:
            task.remaining += self.penalty_ms
        super().on_chunk_limit(core, task, t)


@dataclass
class GatewayResult:
    sim: SimResult
    arch: str
    policy: str
    redispatches: int = 0

    def cost_usd(self) -> float:
        # fsum over the canonical finished-task order: the bill is
        # bit-identical under any permutation of the completed list.
        return math.fsum(
            (t.execution / 1000.0) * (t.mem_mb / 1024.0)
            * DEFAULT_PRICING.price_per_gb_second
            + DEFAULT_PRICING.price_per_request
            for t in self.sim.finished_tasks())

    def summary(self) -> dict:
        s = self.sim.summary()
        s["arch"] = self.arch
        s["cost_usd"] = self.cost_usd()
        s["redispatches"] = self.redispatches
        return s


def requests_from_trace(cfg: ModelConfig, spec: Optional[TraceSpec] = None,
                        seed: int = 0) -> list[Task]:
    """Map the Azure-like workload onto inference requests: the task's
    CPU service time becomes (prefill + decode) token budgets with the
    per-arch tokens/s model; memory = weights share + KV footprint."""
    w = generate_workload(spec or TraceSpec())
    rng = np.random.default_rng(seed)
    tasks = []
    for t in w.tasks:
        decode = max(int(t.service / cfg.ms_per_token_decode), 1)
        prompt = int(min(decode * rng.uniform(2.0, 8.0), 8192))
        svc = service_ms(cfg, prompt, decode)
        mem_mb = t.mem_mb  # Azure memory-size distribution (billing)
        tasks.append(Task(tid=t.tid, arrival=t.arrival, service=svc,
                          mem_mb=mem_mb, func_id=t.func_id,
                          bucket=t.bucket, deadline=t.deadline))
    return tasks


def _request_workload(cfg: ModelConfig, requests, trace):
    """Shim helper: explicit requests are deep-copied (the historical
    contract lets callers reuse their list); trace-derived streams are
    fresh already."""
    from ..scenario import WorkloadSpec
    if requests is not None:
        return WorkloadSpec(kind="tasks", tasks=requests)
    return WorkloadSpec(kind="tasks",
                        tasks=requests_from_trace(cfg, trace), fresh=False)


def run_gateway(cfg: ModelConfig, policy: str = "hybrid", *,
                n_slots: int = 50, n_fifo: int = 25,
                requests: Optional[list[Task]] = None,
                adapt_pct: Optional[float] = 95.0,
                rightsize: bool = True,
                seq_len: int = 4096,
                straggler_factor: float = 0.0,
                containers: Optional[ContainerConfig] = None,
                trace: Optional[TraceSpec] = None) -> GatewayResult:
    """Deprecated: build a :class:`repro_torch.Scenario` with a
    ``ServingSpec`` and call ``repro_torch.run``. This shim routes through
    exactly that path (results stay bit-identical)."""
    warnings.warn(
        "run_gateway() is deprecated; use repro_torch.run(Scenario(policy="
        "PolicySpec(serving=ServingSpec(...)), ...)) instead",
        DeprecationWarning, stacklevel=2)
    from ..scenario import (FleetSpec, PolicySpec, Scenario, ServingSpec,
                            run)
    sc = Scenario(
        workload=_request_workload(cfg, requests, trace),
        fleet=FleetSpec(n_nodes=1, cores_per_node=n_slots,
                        containers=containers),
        policy=PolicySpec(
            name=policy, adapt_pct=adapt_pct, rightsize=rightsize,
            n_fifo=n_fifo if policy == "hybrid" else None,
            serving=ServingSpec(model=cfg, seq_len=seq_len,
                                straggler_factor=straggler_factor)))
    res = run(sc)
    return GatewayResult(sim=res.raw, arch=cfg.name, policy=policy,
                         redispatches=getattr(res.raw, "redispatches", 0))


# -- fleet gateway ------------------------------------------------------------

def _slot_node_factory(cfg: ModelConfig, seq_len: int, n_fifo_frac: float,
                       adapt_pct: Optional[float], rightsize: bool,
                       straggler_factor: float = 0.0,
                       containers: Optional[ContainerConfig] = None):
    """Build slot schedulers for one node — the single switch shared by
    ``run_gateway`` (one big node) and ``run_gateway_fleet``. With
    ``containers`` set, each node gets a sandbox pool: the model-serving
    analogue of a warm container is resident per-function state (loaded
    adapters / compiled graphs), and a cold slot pays the boot delay on
    its billed wall-clock span like any other FaaS invocation.
    ``containers`` accepts any shape ``as_container_config`` does
    (spec / config / kwargs dict / policy name)."""
    containers = as_container_config(containers)

    def factory(policy: str, n_cores: int, **kw):
        if containers is not None:
            kw.setdefault("containers", containers)
        if policy == "hybrid":
            # An explicit n_fifo (single-node run_gateway) passes
            # through untouched so invalid splits still fail loudly.
            n_fifo = kw.pop("n_fifo", None)
            if n_fifo is None:
                n_fifo = max(1, min(n_cores - 1,
                                    round(n_cores * n_fifo_frac)))
            return SlotHybridScheduler(
                cfg, seq_len=seq_len, n_cores=n_cores, n_fifo=n_fifo,
                adapter=(TimeLimitAdapter(pct=adapt_pct)
                         if adapt_pct else None),
                rightsizer=Rightsizer() if rightsize else None,
                straggler_factor=straggler_factor, **kw)
        if policy == "cfs":
            return SlotCFS(cfg, seq_len=seq_len, n_cores=n_cores, **kw)
        if policy == "fifo":
            return FIFO(n_cores=n_cores, **kw)
        raise KeyError(policy)
    return factory


def run_gateway_fleet(cfg: ModelConfig, policy: str = "hybrid", *,
                      n_nodes: int = 4, slots_per_node: int = 16,
                      dispatcher: str = "least_loaded",
                      requests: Optional[list[Task]] = None,
                      adapt_pct: Optional[float] = 95.0,
                      rightsize: bool = True,
                      n_fifo_frac: float = 0.5,
                      seq_len: int = 4096,
                      straggler_factor: float = 0.0,
                      containers: Optional[ContainerConfig] = None,
                      seed: int = 0,
                      trace: Optional[TraceSpec] = None):
    """Deprecated: build a :class:`repro_torch.Scenario` with a fleet spec
    and a ``ServingSpec`` and call ``repro_torch.run``. This shim routes
    through exactly that path (results stay bit-identical). Returns a
    ``repro_torch.cluster.ClusterResult`` (serving slots = "cores")."""
    warnings.warn(
        "run_gateway_fleet() is deprecated; use repro_torch.run(Scenario("
        "fleet=FleetSpec(...), policy=PolicySpec(serving="
        "ServingSpec(...)))) instead",
        DeprecationWarning, stacklevel=2)
    from ..scenario import (FleetSpec, PolicySpec, Scenario, ServingSpec,
                            run)
    sc = Scenario(
        workload=_request_workload(cfg, requests, trace),
        fleet=FleetSpec(n_nodes=n_nodes, cores_per_node=slots_per_node,
                        dispatcher=dispatcher, containers=containers,
                        seed=seed),
        policy=PolicySpec(
            name=policy, adapt_pct=adapt_pct, rightsize=rightsize,
            serving=ServingSpec(model=cfg, seq_len=seq_len,
                                n_fifo_frac=n_fifo_frac,
                                straggler_factor=straggler_factor)))
    return run(sc).raw
