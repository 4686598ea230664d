"""rwkv6-1.6b [ssm]: 24L d=2048 attention-free (RWKV6 "Finch"
data-dependent decay), d_ff=7168, vocab 65536.  [arXiv:2404.05892]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab=65536, tie_embeddings=False,
    ms_per_token_decode=2.0, ms_per_ktoken_prefill=5.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=64, d_ff=128, vocab=256)
