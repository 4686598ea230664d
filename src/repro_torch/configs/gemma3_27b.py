"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504,
vocab 262144, 5:1 local(1024-window):global attention, 128k context.
[hf:google/gemma-3-1b-pt]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144, local_window=1024, local_global_ratio=5,
    tie_embeddings=True, rope_theta=1e6, attn_logit_softcap=0.0,
    ms_per_token_decode=14.0, ms_per_ktoken_prefill=45.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=13, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, local_window=16)
