"""repro_torch.cluster — multi-node fleet simulation over per-node
schedulers (own copy of ``repro.cluster``).

A provider runs fleets, and the cluster dispatcher decides which node an
invocation lands on before the node-level FIFO+CFS hybrid ever sees it.
This package composes the single-node simulators into a fleet: pluggable
front-end dispatch (``dispatch``), the interleaved multi-node event loop
(``sim``), fleet-level roll-ups (``metrics``), the resilience layers
(``admission``, ``chaos``, ``prewarm``, ``retry``, ``topology``) and a
parallel grid runner (``sweep``).
"""
from .admission import AdmissionConfig, AdmissionControl, make_admission
from .chaos import (ChaosEvent, ChaosSchedule, churn_preset, kill_heal,
                    zone_failure_preset)
from .dispatch import (DISPATCHERS, AffinityDispatch, CostAwareDispatch,
                       Dispatcher, JoinIdleQueueDispatch,
                       LeastLoadedDispatch, RandomDispatch,
                       RoundRobinDispatch, WarmAffinityDispatch,
                       WarmLeastLoadedDispatch, make_dispatcher)
from .metrics import ClusterResult
from .prewarm import PrewarmConfig, Provisioner, build_plan
from .retry import RetryPolicy, RetryState, make_retry
from .sim import ClusterNode, ClusterSim, run_cluster
from .sweep import (PRESETS, Cell, build_grid, compare_serial, merge_rows,
                    run_cell, run_sweep, shard_grid)
from .topology import SKUS, NodePlacement, NodeSKU, TopologySpec, as_sku

__all__ = [
    "DISPATCHERS", "AffinityDispatch", "CostAwareDispatch", "Dispatcher",
    "JoinIdleQueueDispatch", "LeastLoadedDispatch", "RandomDispatch",
    "RoundRobinDispatch", "WarmAffinityDispatch",
    "WarmLeastLoadedDispatch", "make_dispatcher", "ClusterResult",
    "ClusterNode", "ClusterSim", "run_cluster", "PRESETS", "Cell",
    "build_grid", "compare_serial", "run_cell", "run_sweep",
    "AdmissionConfig", "AdmissionControl", "make_admission",
    "ChaosEvent", "ChaosSchedule", "churn_preset", "kill_heal",
    "PrewarmConfig", "Provisioner", "build_plan", "merge_rows",
    "shard_grid",
    "zone_failure_preset", "RetryPolicy", "RetryState",
    "make_retry", "SKUS", "NodePlacement", "NodeSKU", "TopologySpec",
    "as_sku",
]
