"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab 49155, 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, n_experts=40, top_k=8,
    tie_embeddings=True, rope_theta=1e4,
    ms_per_token_decode=3.0, ms_per_ktoken_prefill=9.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                        d_ff=64, vocab=256, n_experts=4, top_k=2,
                        capacity_factor=8.0)  # dropless for path-consistency tests
