"""repro_torch.serving — the real-model serving engine of the port."""
from .engine import LiveRequest, ServingEngine
from .request import kv_bytes, preemption_penalty_ms

__all__ = ["LiveRequest", "ServingEngine", "kv_bytes",
           "preemption_penalty_ms"]
