"""deepseek-7b [dense]: 30L d=4096 32H (MHA kv=32) d_ff=11008,
vocab 102400, llama architecture.  [arXiv:2401.02954]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, tie_embeddings=False, rope_theta=1e4,
    ms_per_token_decode=4.5, ms_per_ktoken_prefill=14.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=256)
