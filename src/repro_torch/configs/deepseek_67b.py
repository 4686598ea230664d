"""deepseek-67b [dense]: 95L d=8192 64H (GQA kv=8) d_ff=22016,
vocab 102400, llama architecture.  [arXiv:2401.02954]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, tie_embeddings=False, rope_theta=1e4,
    ms_per_token_decode=25.0, ms_per_ktoken_prefill=90.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=96, n_heads=8, n_kv_heads=2,
                        d_ff=192, vocab=256)
