"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960, vocab 151936,
M-RoPE + dynamic resolution (the ViT frontend is a stub:
``models.frontends`` supplies patch embeddings).  [arXiv:2409.12191]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, mrope=True, mrope_sections=(16, 24, 24),
    modality="vision", tie_embeddings=True, rope_theta=1e6,
    ms_per_token_decode=2.5, ms_per_ktoken_prefill=7.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, mrope_sections=(2, 3, 3))
