"""repro_torch.traces — own copy of the Azure-like workload synthesis."""
from .azure import (BUCKET_MS, BUCKET_WEIGHTS, FIB_N, PHI, FunctionMeta,
                    TraceSpec, synth_functions)
from .workload import (P90_ANCHOR_MS, Workload, generate_workload,
                       keepalive_hints, scale_load, shard_tasks,
                       workload_file)

__all__ = ["BUCKET_MS", "BUCKET_WEIGHTS", "FIB_N", "PHI", "FunctionMeta",
           "TraceSpec", "synth_functions", "P90_ANCHOR_MS", "Workload",
           "generate_workload", "keepalive_hints", "scale_load",
           "shard_tasks", "workload_file"]
