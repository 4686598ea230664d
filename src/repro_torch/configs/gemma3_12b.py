"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360,
vocab 262144, 5:1 local(1024-window):global attention, 128k context.
[hf:google/gemma-3-1b-pt]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, local_window=1024, local_global_ratio=5,
    tie_embeddings=True, rope_theta=1e6,
    ms_per_token_decode=8.0, ms_per_ktoken_prefill=28.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=7, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, local_window=16)
