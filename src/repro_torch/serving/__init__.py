"""repro_torch.serving — the real-model serving engine of the port and
the ``llm`` workload the simulator prices."""
from .engine import LiveRequest, ServingEngine
from .llm import (LLMSpec, approx_param_bytes, llm_requests, llm_workload,
                  request_chunks)
from .request import (RequestSpec, kv_bytes, preemption_penalty_ms,
                      service_ms)

__all__ = ["LiveRequest", "ServingEngine", "RequestSpec", "kv_bytes",
           "preemption_penalty_ms", "service_ms", "LLMSpec",
           "approx_param_bytes", "llm_requests", "llm_workload",
           "request_chunks"]
