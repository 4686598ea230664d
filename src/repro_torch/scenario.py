"""The unified entrypoint: ``repro_torch.run(Scenario(...)) -> ScenarioResult``
(own copy of ``repro.scenario``).

A :class:`Scenario` composes the knobs of every front door (trace,
containers, chaos, admission, prewarm, policy) as four orthogonal specs:

* :class:`WorkloadSpec`   — what arrives: an Azure-like synthetic trace,
  an explicit task list, or the **llm** workload (``serving.llm``) where
  model replicas are the functions, cold start = weight-load + compile,
  warm state = KV/weights residency, tasks = prefill/decode chunks;
* :class:`FleetSpec`      — where it runs: node count/size, front-end
  dispatcher, the sandbox layer (any ``ContainerSpec``-coercible shape),
  per-node policy overrides;
* :class:`PolicySpec`     — how each node schedules: policy name plus
  the paper's knobs (time-limit adaptation, rightsizing, FIFO split),
  and an optional :class:`ServingSpec` that switches nodes to the
  KV-penalty slot schedulers;
* :class:`ResilienceSpec` — chaos schedule, admission control,
  predictive pre-warming (DESIGN.md Sec. 14).

``run`` picks the execution engine from the specs: a lone node with no
dispatcher runs the single-node scheduler directly; anything else runs
through :class:`~repro_torch.cluster.sim.ClusterSim`. The older
entrypoints (``core.simulate.run_policy``, ``cluster.sim.run_cluster``,
``serving.gateway.run_gateway`` / ``run_gateway_fleet``) are thin
deprecation shims built on exactly this path, so their roll-ups equal
the Scenario's bit for bit by construction. Every float is computed as
the JAX package's ``repro.run`` computes it, in the same order, so both
packages give the same results bit for bit.

``ScenarioResult.summary()`` is the versioned roll-up schema
(``SCHEMA_VERSION``/``SUMMARY_KEYS_V1``, the JAX package's unchanged):
every summary carries at least the v1 keys, with zeros where a layer is
off, and schema growth is additive-only.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Optional, Sequence, Union

from .cluster.admission import AdmissionConfig, AdmissionControl
from .cluster.chaos import ChaosSchedule
from .cluster.metrics import ClusterResult
from .cluster.prewarm import (PrewarmConfig, Provisioner,
                              make_prewarm_config)
from .cluster.retry import RetryPolicy
from .cluster.sim import ClusterSim
from .cluster.topology import TopologySpec
from .core.containers import (ContainerConfig, ContainerSpec,
                              as_container_config)
from .core.events import Task
from .core.metrics import SimResult
from .traces.azure import TraceSpec
from .traces.workload import generate_workload, scale_load

if TYPE_CHECKING:  # resolved lazily at run time
    from .configs.base import ModelConfig
    from .serving.llm import LLMSpec

SCHEMA_VERSION = 1

# The frozen v1 core of ``ScenarioResult.summary()``: every summary —
# single-node or fleet, azure or llm — carries at least these keys.
# Growth is ADDITIVE-ONLY: removing or renaming any of these requires a
# SCHEMA_VERSION bump.
SUMMARY_KEYS_V1 = (
    "schema_version", "workload", "policy", "dispatcher",
    "n_nodes", "cores_per_node", "n", "failed", "n_requests",
    "p99_turnaround_s", "makespan_s",
    "cost_usd", "total_cost_usd", "usd_per_1k_requests",
    "cold_starts", "cold_start_rate", "init_cost_usd", "warm_hold_usd",
    "shed", "rejected_cost_usd", "requeued", "chaos_events",
    "queued", "spilled", "prewarmed",
    # -- v1 additive growth: failure-domain topology + retry layer
    # (DESIGN.md Sec. 17); stable zeros when those layers are off.
    "retries", "retry_wait_ms", "revoked", "degraded_ms",
    "cross_zone", "spot_savings_usd",
    # -- v1 additive growth: cost-model substrate (DESIGN.md Sec. 18).
    # Which engine produced the row and why a batched cell fell
    # back to the scalar one, which pricing/cost
    # model priced it, and the learned-coefficient state (cost_aware
    # RLS value, observation count, realized |prediction error|) so
    # the gate and trend dashboard can see model drift.
    "backend", "fallback_reason", "pricing", "cost_model",
    "cost_coeff", "cost_obs", "cost_pred_err_ms",
)


# -- the four orthogonal specs ------------------------------------------------

@dataclass(frozen=True)
class WorkloadSpec:
    """What arrives.

    ``kind``:

    * ``"azure"`` (alias ``"synthetic"``) — the calibrated Azure-like
      trace from ``traces`` (``trace`` is its :class:`TraceSpec`);
    * ``"tasks"`` — an explicit pre-built task list (``tasks``);
      ``fresh=False`` runs the caller's objects in place (the
      historical ``fresh_tasks=False`` contract);
    * ``"llm"`` — model replicas as functions (``llm`` is an
      :class:`~repro_torch.serving.llm.LLMSpec`; ``trace`` drives arrivals).

    ``load_scale`` compresses inter-arrival times after generation
    (>1 = heavier load), exactly like ``traces.workload.scale_load``.
    """

    kind: str = "azure"
    trace: Optional[TraceSpec] = None
    load_scale: float = 1.0
    tasks: Optional[Sequence[Task]] = None
    fresh: bool = True
    llm: Optional["LLMSpec"] = None

    def build(self) -> tuple[list[Task], dict]:
        """Materialize ``(tasks, meta)``; deterministic per spec."""
        if self.kind == "llm":
            from .serving.llm import LLMSpec, llm_workload
            return llm_workload(self.llm or LLMSpec(), self.trace,
                                self.load_scale)
        if self.kind == "tasks":
            if self.tasks is None:
                raise ValueError("WorkloadSpec(kind='tasks') needs tasks=")
            tasks = list(self.tasks)
            if self.fresh:
                tasks = copy.deepcopy(tasks)
        elif self.kind in ("azure", "synthetic"):
            tasks = generate_workload(self.trace or TraceSpec()).tasks
        else:
            raise KeyError(f"unknown workload kind {self.kind!r}")
        if self.load_scale != 1.0:
            tasks = scale_load(tasks, self.load_scale)
        return tasks, {"n_requests": len(tasks)}


@dataclass(frozen=True)
class FleetSpec:
    """Where it runs.

    ``dispatcher=None`` with one node and no per-node overrides runs
    the scheduler directly (the historical single-node entrypoints);
    any dispatcher name (or instance) runs a :class:`ClusterSim` fleet.
    ``containers`` accepts every ``as_container_config`` shape —
    :class:`ContainerSpec`, raw :class:`ContainerConfig`, kwargs dict,
    or a policy-name string. ``nodes`` optionally overrides per-node
    policies (heterogeneous fleets); ``node_factory`` overrides
    scheduler construction outright (the shims' escape hatch).
    """

    n_nodes: int = 1
    cores_per_node: int = 50
    dispatcher: Union[None, str, object] = None
    containers: Union[None, ContainerSpec, ContainerConfig,
                      dict, str] = None
    seed: int = 0
    nodes: Optional[Sequence] = None
    node_factory: Optional[object] = None
    # Failure-domain topology (zones/racks/SKUs — DESIGN.md Sec. 17).
    # When set it IS the fleet shape: node count and placement come
    # from the topology, and ``n_nodes`` is ignored.
    topology: Optional[TopologySpec] = None

    @property
    def is_fleet(self) -> bool:
        return (self.dispatcher is not None or self.n_nodes > 1
                or self.nodes is not None or self.topology is not None)


@dataclass(frozen=True)
class ServingSpec:
    """Switch node schedulers to the serving slot variants: preemptions
    carry the model's KV-swap penalty, quanta scale to dominate it."""

    model: Union[str, "ModelConfig"] = "deepseek-7b"
    seq_len: int = 4096
    n_fifo_frac: float = 0.5        # hybrid: FIFO share of a node's slots
    straggler_factor: float = 0.0

    def resolve_model(self) -> "ModelConfig":
        from .configs.base import ModelConfig
        if isinstance(self.model, ModelConfig):
            return self.model
        from .configs.registry import get_config
        return get_config(self.model)


@dataclass(frozen=True)
class PolicySpec:
    """How each node schedules. ``adapt_pct``/``rightsize``/``n_fifo``
    apply to the hybrid policy; ``microvm``/``ghost_mode`` are the
    paper's single-node system models; ``kw`` passes any remaining
    scheduler kwargs through verbatim (the legacy ``**kw`` contract)."""

    name: str = "hybrid"
    adapt_pct: Optional[float] = None
    rightsize: bool = False
    n_fifo: Optional[int] = None
    microvm: bool = False
    ghost_mode: bool = False
    serving: Optional[ServingSpec] = None
    kw: dict = field(default_factory=dict)


@dataclass(frozen=True)
class ResilienceSpec:
    """Chaos / admission / pre-warm layers — all off by default, and
    bit-identical to the plain run when off (DESIGN.md Sec. 14)."""

    chaos: Optional[ChaosSchedule] = None
    admission: Union[None, dict, AdmissionConfig, AdmissionControl] = None
    prewarm: Union[None, dict, PrewarmConfig, Provisioner,
                   Sequence] = None
    # Retry layer for chaos-lost work: capped exponential backoff with
    # deterministic jitter, retry budget, per-function circuit breaker
    # (None keeps the instant-requeue semantics, bit-identically).
    retry: Union[None, dict, RetryPolicy] = None

    def materialize_prewarm(self, tasks) -> Union[None, Provisioner,
                                                  Sequence]:
        """Config-shaped prewarm builds a fresh plan from THIS run's
        workload (a ``Provisioner`` is single-use); plans/provisioners
        pass through for ``ClusterSim`` to consume."""
        pw = self.prewarm
        if isinstance(pw, (dict, PrewarmConfig)):
            return Provisioner.from_workload(tasks, make_prewarm_config(pw))
        return pw


@dataclass(frozen=True)
class Scenario:
    """One reproducible experiment: workload x fleet x policy x
    resilience — priced by ``pricing`` and costed by ``cost_model``.
    ``repro_torch.run(scenario)`` executes it.

    ``pricing`` accepts ``None`` | preset name | kwargs dict |
    :class:`~repro_torch.costmodel.pricing.PricingSpec`; ``None`` keeps the
    historical constants bit-identically. ``cost_model`` accepts
    ``None`` | ``"static"`` | ``"learned"`` | calibration-artifact dict
    or path | :class:`~repro_torch.costmodel.model.CostModel`; ``None`` /
    ``"static"`` is the do-nothing default, ``"learned"`` threads the
    calibrated predictor into llm chunk pricing, cost_aware dispatch,
    the admission ceiling (``max_load="auto"``) and predictive pre-warm
    (DESIGN.md Sec. 18).
    """

    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    fleet: FleetSpec = field(default_factory=FleetSpec)
    policy: PolicySpec = field(default_factory=PolicySpec)
    resilience: ResilienceSpec = field(default_factory=ResilienceSpec)
    pricing: Union[None, str, dict, object] = None
    cost_model: Union[None, str, dict, object] = None


# -- cost-model plumbing ------------------------------------------------------

def _pricing_name(pricing) -> str:
    """The summary-schema label for a Scenario's pricing field."""
    if pricing is None:
        return "default"
    from .costmodel.pricing import make_pricing
    return make_pricing(pricing).name


def _cost_model_kind(cost_model) -> str:
    """The summary-schema label for a Scenario's cost_model field."""
    if cost_model is None or cost_model == "static":
        return "static"
    if isinstance(cost_model, (str, dict)):
        return "learned"
    return getattr(cost_model, "kind", "learned")


def _resolve_resilience(res: ResilienceSpec, cost_model) -> ResilienceSpec:
    """Resolve the cost-model-derived resilience knobs before the run:
    ``max_load="auto"`` becomes the model's predicted-inflation ceiling
    (consumer 3), and a learned model switches config-shaped pre-warm
    to its online forecaster unless the config chose one explicitly
    (consumer 4)."""
    adm = res.admission
    if isinstance(adm, dict) and adm.get("max_load") == "auto":
        budget = adm.get("max_queue_ms", AdmissionConfig.max_queue_ms)
        adm = dict(adm, max_load=cost_model.derive_max_load(budget))
        res = replace(res, admission=adm)
    elif isinstance(adm, AdmissionConfig) and adm.max_load == "auto":
        adm = replace(adm,
                      max_load=cost_model.derive_max_load(adm.max_queue_ms))
        res = replace(res, admission=adm)
    pw = res.prewarm
    if isinstance(pw, dict) and "forecast" not in pw \
            and cost_model.prewarm_forecast() != "oracle":
        res = replace(res, prewarm=dict(
            pw, forecast=cost_model.prewarm_forecast()))
    return res


# -- result + versioned summary schema ----------------------------------------

@dataclass
class ScenarioResult:
    """The scenario plus its raw engine result (``SimResult`` for a
    direct single-node run, ``ClusterResult`` for a fleet) and the
    workload metadata. ``summary()`` is the stable v1 schema."""

    scenario: Scenario
    raw: Union[SimResult, ClusterResult]
    meta: dict = field(default_factory=dict)
    # Batched-engine accounting (repro_torch.mc): kernel loop trips and
    # scheduling events retired for this cell. Diagnostics only — NEVER
    # part of the v1 summary schema, so scalar and batched summaries
    # stay byte-identical.
    mc_stats: Optional[dict] = None

    @property
    def n_requests(self) -> int:
        return int(self.meta.get("n_requests", 0))

    def total_cost_usd(self) -> float:
        if isinstance(self.raw, ClusterResult):
            return self.raw.total_cost_usd()
        return self.raw.cost_usd()

    def usd_per_1k_requests(self) -> float:
        n = self.n_requests
        return self.total_cost_usd() / n * 1000.0 if n else 0.0

    def summary(self) -> dict:
        sc = self.scenario
        # v1 frame: stable zeros for every layer that is off, so the
        # gate/trend/CSV schemas never fork on topology or workload.
        out = {k: 0 for k in SUMMARY_KEYS_V1}
        out.update({
            "dispatcher": "none",
            "n_nodes": 1,
            "cores_per_node": sc.fleet.cores_per_node,
            "cold_start_rate": 0.0,
            "init_cost_usd": 0.0, "warm_hold_usd": 0.0,
            "rejected_cost_usd": 0.0,
            "retry_wait_ms": 0.0, "degraded_ms": 0.0,
            "spot_savings_usd": 0.0,
            # Cost-model substrate defaults (DESIGN.md Sec. 18): the
            # scalar python engine, no fallback, learned state zeroed
            # (ClusterResult overlays real values when the dispatcher
            # carries an estimator; the sweep overrides backend/
            # fallback_reason per row).
            "backend": "python", "fallback_reason": "none",
            "cost_coeff": 0.0, "cost_pred_err_ms": 0.0,
        })
        out.update(self.raw.summary())
        for k, v in self.meta.items():
            out.setdefault(k, v)
        out.update({
            "schema_version": SCHEMA_VERSION,
            "workload": sc.workload.kind,
            "policy": sc.policy.name,
            "pricing": _pricing_name(sc.pricing),
            "cost_model": _cost_model_kind(sc.cost_model),
            "n_requests": self.n_requests or out["n"],
            "total_cost_usd": self.total_cost_usd(),
        })
        n = out["n_requests"]
        out["usd_per_1k_requests"] = \
            out["total_cost_usd"] / n * 1000.0 if n else 0.0
        return out


# -- execution ----------------------------------------------------------------

def _serving_node_factory(serving: ServingSpec, pol: PolicySpec,
                          containers=None):
    from .serving.gateway import _slot_node_factory
    return _slot_node_factory(
        serving.resolve_model(), serving.seq_len, serving.n_fifo_frac,
        pol.adapt_pct, pol.rightsize,
        straggler_factor=serving.straggler_factor, containers=containers)


def _policy_node_factory(pol: PolicySpec):
    """Per-node scheduler construction honouring the hybrid knobs —
    adapter/rightsizer objects are stateful and must be FRESH per node,
    so they cannot ride in a shared NodeSpec kwargs dict."""
    from .core.hybrid import Rightsizer, TimeLimitAdapter
    from .core.simulate import make_scheduler

    def factory(policy: str, n_cores: int, **kw):
        if policy == "hybrid":
            if pol.adapt_pct is not None:
                kw.setdefault("adapter", TimeLimitAdapter(pct=pol.adapt_pct))
            if pol.rightsize:
                kw.setdefault("rightsizer", Rightsizer())
            if pol.n_fifo is not None:
                kw.setdefault("n_fifo", pol.n_fifo)
        return make_scheduler(policy, n_cores=n_cores, **kw)
    return factory


def _run_single(tasks: list[Task], containers, sc: Scenario,
                serving: Optional[ServingSpec]) -> SimResult:
    pol = sc.policy
    if serving is not None:
        from .core.metrics import collect
        factory = _serving_node_factory(serving, pol, containers)
        kw = dict(pol.kw)
        if pol.name == "hybrid" and pol.n_fifo is not None:
            kw["n_fifo"] = pol.n_fifo
        sched = factory(pol.name, n_cores=sc.fleet.cores_per_node, **kw)
        sched.run(tasks)
        out = collect(sched, pol.name)
        out.redispatches = getattr(sched, "redispatches", 0)
        return out
    from .core.simulate import execute_policy
    return execute_policy(
        pol.name, tasks, n_cores=sc.fleet.cores_per_node,
        adapt_pct=pol.adapt_pct, rightsize=pol.rightsize,
        microvm=pol.microvm, ghost_mode=pol.ghost_mode,
        containers=containers, fresh_tasks=False, **pol.kw)


def _run_fleet(tasks: list[Task], containers, sc: Scenario,
               serving: Optional[ServingSpec], cost_model=None,
               pricing=None,
               res: Optional[ResilienceSpec] = None) -> ClusterResult:
    fl, pol = sc.fleet, sc.policy
    if res is None:
        res = sc.resilience
    if pol.microvm or pol.ghost_mode:
        raise ValueError("microvm/ghost_mode are single-node system "
                         "models; use FleetSpec(dispatcher=None, "
                         "n_nodes=1)")
    factory = fl.node_factory
    if factory is None:
        if serving is not None:
            # Containers go through ClusterSim (not the factory) so
            # each node's pool keeps its own seed stream.
            factory = _serving_node_factory(serving, pol, containers=None)
        elif (pol.adapt_pct is not None or pol.rightsize
                or pol.n_fifo is not None):
            factory = _policy_node_factory(pol)
    if fl.nodes is not None:
        node_spec = list(fl.nodes)
    elif pol.kw:
        node_spec = (pol.name, dict(pol.kw))
    else:
        node_spec = pol.name
    dispatcher = fl.dispatcher if fl.dispatcher is not None \
        else "least_loaded"
    if dispatcher == "cost_aware" and cost_model is not None \
            and (cost_model.kind != "static" or pricing is not None):
        # Consumer 2: the cost model supplies the dispatcher's
        # queueing prior and (when learned) SHARES its online RLS, so
        # routing and the reported coefficient are one value. The
        # default static/no-pricing path keeps the plain string —
        # ClusterSim builds the identical historical dispatcher.
        from .cluster.dispatch import CostAwareDispatch
        kw = dict(seed=fl.seed, pricing=pricing,
                  queue_ms_per_load=cost_model.queue_ms_per_load())
        if getattr(cost_model, "rls", None) is not None:
            kw["rls"] = cost_model.rls
        dispatcher = CostAwareDispatch(**kw)
    sim = ClusterSim(
        n_nodes=fl.n_nodes, cores_per_node=fl.cores_per_node,
        node_policies=node_spec,
        dispatcher=dispatcher,
        seed=fl.seed, node_factory=factory, containers=containers,
        admission=res.admission, topology=fl.topology)
    out = sim.run(tasks, fresh_tasks=False, chaos=res.chaos,
                  prewarm=res.materialize_prewarm(tasks),
                  retry=res.retry)
    if serving is not None:
        out.redispatches = sum(getattr(n.sched, "redispatches", 0)
                               for n in sim.nodes)
    return out


def run(scenario: Scenario) -> ScenarioResult:
    """Execute a :class:`Scenario` — THE entrypoint every legacy front
    door now routes through."""
    sc = scenario
    from .costmodel.model import make_cost_model
    from .costmodel.pricing import resolve_pricing
    pricing = resolve_pricing(sc.pricing)   # None stays None: legacy path
    cost_model = make_cost_model(sc.cost_model, pricing=sc.pricing)
    workload = sc.workload
    llm = None
    if workload.kind == "llm":
        from .serving.llm import LLMSpec
        llm = workload.llm or LLMSpec()
        # Consumer 1: a learned model replaces the LLMSpec's constant
        # token costs with calibrated ones (static returns None and the
        # spec constants stand, bit-identically).
        tc = cost_model.token_costs(llm.resolve_model(), llm.seq_len)
        if tc is not None:
            cfg = llm.resolve_model().with_(
                ms_per_ktoken_prefill=tc[0], ms_per_token_decode=tc[1])
            llm = replace(llm, model=cfg)
            workload = replace(workload, llm=llm)
    tasks, meta = workload.build()
    serving = sc.policy.serving
    containers = sc.fleet.containers
    if llm is not None:
        if serving is None:
            # llm workloads serve through the slot schedulers by
            # default: preemption = KV swap, quanta sized to match.
            serving = ServingSpec(model=llm.model, seq_len=llm.seq_len)
        if containers is None:
            # ...and meter replica instantiation as the sandbox cold
            # start: weight-load + compile, warm pool = KV residency.
            containers = llm.container_spec()
    containers = as_container_config(containers, tasks)
    res = _resolve_resilience(sc.resilience, cost_model)
    if sc.fleet.is_fleet:
        raw = _run_fleet(tasks, containers, sc, serving,
                         cost_model=cost_model, pricing=pricing, res=res)
    else:
        raw = _run_single(tasks, containers, sc, serving)
    if pricing is not None:
        # Non-default pricing re-prices every roll-up; the None default
        # leaves the historical (bit-identical) constant path in place.
        raw.pricing = pricing
        if isinstance(raw, ClusterResult):
            for r in raw.node_results:
                r.pricing = pricing
    return ScenarioResult(scenario=sc, raw=raw, meta=dict(meta))
