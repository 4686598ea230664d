"""zamba2-1.2b [hybrid]: 38L Mamba2 backbone (d=2048, ssm_state=64) with a
weight-SHARED attention+MLP block (32H kv=32, d_ff=8192) applied every 6
layers, vocab 32000.  [arXiv:2411.15242]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, ssm_state=64, shared_attn_every=6,
    tie_embeddings=True,
    ms_per_token_decode=2.5, ms_per_ktoken_prefill=6.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=256, ssm_state=16,
                        shared_attn_every=3, ssm_chunk=16)
