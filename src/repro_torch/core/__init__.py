"""repro_torch.core — own copy of the simulator: the discrete-event
engine, the single-level policies, the hybrid two-group scheduler, the
container lifecycle layer, the cost roll-ups, ``execute_policy`` and the
``run_policy`` shim over ``repro_torch.run``."""
from .containers import (ContainerConfig, ContainerPool, ContainerSpec,
                         as_container_config, expected_cold_ms)
from .events import Core, Scheduler, Task, GROUP_CFS, GROUP_FIFO
from .policies import CFS, EDF, FIFO, FIFOPreempt, RoundRobin
from .hybrid import HybridScheduler, Rightsizer, TimeLimitAdapter, percentile
from .metrics import SimResult, collect
from .simulate import (POLICIES, execute_policy, make_scheduler,
                       run_policy)
from . import cost

__all__ = [
    "ContainerConfig", "ContainerPool", "ContainerSpec",
    "as_container_config", "expected_cold_ms",
    "Core", "Scheduler", "Task", "GROUP_CFS", "GROUP_FIFO",
    "CFS", "EDF", "FIFO", "FIFOPreempt", "RoundRobin",
    "HybridScheduler", "Rightsizer", "TimeLimitAdapter", "percentile",
    "SimResult", "collect", "POLICIES", "execute_policy",
    "make_scheduler", "run_policy", "cost",
]
