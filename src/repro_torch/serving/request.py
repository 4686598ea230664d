"""Inference request model and per-arch service / preemption cost (own
copy of ``repro.serving.request``)."""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig

HOST_OFFLOAD_BW = 10e9          # bytes/s device<->host for KV offload
DISPATCH_BUBBLE_MS = 2.0        # re-dispatch latency after a swap


@dataclass
class RequestSpec:
    rid: int
    arrival_ms: float
    prompt_tokens: int
    decode_tokens: int
    mem_gb: float = 0.5          # billed footprint (weights share + KV)
    func_id: int = 0             # model endpoint (FaaS function) it hits


def service_ms(cfg: ModelConfig, prompt: int, decode: int) -> float:
    """Modelled uninterrupted service time of a request on one slot."""
    return (cfg.ms_per_ktoken_prefill * prompt / 1000.0
            + cfg.ms_per_token_decode * decode)


def kv_bytes(cfg: ModelConfig, seq_len: int) -> float:
    """Live state a preemption must save+restore. Attention archs carry
    O(seq) KV; SSM/hybrid archs carry O(1) recurrent state."""
    if cfg.family == "ssm":
        nh = cfg.d_model // cfg.rwkv_head_dim
        return cfg.n_layers * (nh * cfg.rwkv_head_dim ** 2 + 2 * cfg.d_model) * 4
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        ssm = cfg.n_layers * nh * cfg.ssm_head_dim * cfg.ssm_state * 4
        napp = max(1, cfg.n_layers // max(cfg.shared_attn_every, 1))
        attn = napp * 2 * cfg.n_kv_heads * cfg.hd * seq_len * 2
        return ssm + attn
    per_layer = 2 * cfg.n_kv_heads * cfg.hd * seq_len * 2   # k+v bf16
    if cfg.local_global_ratio > 0:
        R = cfg.local_global_ratio
        G = cfg.n_layers // (R + 1)
        n_local = cfg.n_layers - G
        w = min(cfg.local_window, seq_len)
        return (G * per_layer
                + n_local * 2 * cfg.n_kv_heads * cfg.hd * w * 2)
    return cfg.n_layers * per_layer


def preemption_penalty_ms(cfg: ModelConfig, seq_len: int) -> float:
    """Modelled context switch of a decode lane: KV/state offload +
    restore + dispatch bubble."""
    xfer = 2.0 * kv_bytes(cfg, seq_len) / HOST_OFFLOAD_BW * 1000.0
    return xfer + DISPATCH_BUBBLE_MS
