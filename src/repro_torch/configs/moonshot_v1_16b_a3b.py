"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (GQA kv=16) d_ff=1408/expert,
vocab 163840, 64 experts top-6, first layer dense (Moonlight/DeepSeek
style).  [hf:moonshotai/Moonlight-16B-A3B]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6, first_k_dense=1,
    tie_embeddings=False, rope_theta=5e4,
    ms_per_token_decode=6.0, ms_per_ktoken_prefill=18.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=48, vocab=256, n_experts=8, top_k=2,
                        first_k_dense=1, capacity_factor=8.0)
