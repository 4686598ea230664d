"""repro_torch.cluster — multi-node fleet simulation over per-node
schedulers (own copy of ``repro.cluster``, less the grid runner
``sweep``).

A provider runs fleets, and the cluster dispatcher decides which node an
invocation lands on before the node-level FIFO+CFS hybrid ever sees it.
This package composes the single-node simulators into a fleet: pluggable
front-end dispatch (``dispatch``), the interleaved multi-node event loop
(``sim``), fleet-level roll-ups (``metrics``), and the resilience layers
(``admission``, ``chaos``, ``prewarm``, ``retry``, ``topology``).
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
from .topology import SKUS, NodePlacement, NodeSKU, TopologySpec, as_sku

__all__ = [
    "DISPATCHERS", "AffinityDispatch", "CostAwareDispatch", "Dispatcher",
    "JoinIdleQueueDispatch", "LeastLoadedDispatch", "RandomDispatch",
    "RoundRobinDispatch", "WarmAffinityDispatch",
    "WarmLeastLoadedDispatch", "make_dispatcher", "ClusterResult",
    "ClusterNode", "ClusterSim", "run_cluster",
    "AdmissionConfig", "AdmissionControl", "make_admission",
    "ChaosEvent", "ChaosSchedule", "churn_preset", "kill_heal",
    "PrewarmConfig", "Provisioner", "build_plan",
    "zone_failure_preset", "RetryPolicy", "RetryState",
    "make_retry", "SKUS", "NodePlacement", "NodeSKU", "TopologySpec",
    "as_sku",
]
