"""Paper experiment configuration (own copy of ``repro.configs.paper``):
the scheduler knobs and the workload of the paper's one node."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..traces.azure import TraceSpec


@dataclass(frozen=True)
class SchedulerConfig:
    n_cores: int = 50                # 50-core ghOSt enclave (paper Sec. V-C)
    n_fifo: int = 25                 # best split (Fig. 11)
    time_limit_ms: float = 1633.0    # p90 of the workload (Sec. II-E)
    adapt_pct: float = 95.0          # best percentile (Fig. 15)
    adapt_window: int = 100          # most recent 100 durations (Sec. IV-B)
    rightsize_interval_ms: float = 1000.0
    rightsize_threshold: float = 0.15
    ctx_switch_ms: float = 0.06
    sched_latency_ms: float = 24.0
    min_granularity_ms: float = 3.0
    ghost_mode: bool = False         # native-CFS interference model


@dataclass(frozen=True)
class PaperConfig:
    trace: TraceSpec = field(default_factory=TraceSpec)
    sched: SchedulerConfig = field(default_factory=SchedulerConfig)


CONFIG = PaperConfig()
