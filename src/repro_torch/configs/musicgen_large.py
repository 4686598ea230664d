"""musicgen-large [audio]: 48L d=2048 32H (MHA kv=32) d_ff=8192,
vocab 2048 — decoder-only over EnCodec RVQ tokens (4 codebooks, delay
pattern; the EnCodec frontend is a stub: ``models.frontends``).
[arXiv:2306.05284]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, modality="audio", tie_embeddings=False,
    ms_per_token_decode=4.0, ms_per_ktoken_prefill=12.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=128)
