"""repro_torch.serving — the real-model serving engine of the port, the
FaaS-for-models gateway over device slots and the ``llm`` workload the
simulator prices."""
from .engine import LiveRequest, ServingEngine
from .gateway import (GatewayResult, SlotCFS, SlotHybridScheduler,
                      requests_from_trace, run_gateway, run_gateway_fleet)
from .llm import (LLMSpec, approx_param_bytes, llm_requests, llm_workload,
                  request_chunks)
from .request import (RequestSpec, kv_bytes, preemption_penalty_ms,
                      service_ms)

__all__ = ["LiveRequest", "ServingEngine", "GatewayResult", "SlotCFS",
           "SlotHybridScheduler", "requests_from_trace", "run_gateway",
           "run_gateway_fleet", "RequestSpec", "kv_bytes",
           "preemption_penalty_ms", "service_ms", "LLMSpec",
           "approx_param_bytes", "llm_requests", "llm_workload",
           "request_chunks"]
