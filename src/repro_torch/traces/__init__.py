"""repro_torch.traces — own copy of the Azure-like workload synthesis."""
from .azure import BUCKET_MS, FIB_N, FunctionMeta, TraceSpec, synth_functions
from .workload import P90_ANCHOR_MS, Workload, generate_workload, scale_load

__all__ = ["BUCKET_MS", "FIB_N", "FunctionMeta", "TraceSpec",
           "synth_functions", "P90_ANCHOR_MS", "Workload",
           "generate_workload", "scale_load"]
