"""Model configuration dataclass and the input shapes (own copy of
``repro.configs.base``).

Kept field for field with the JAX package's ``ModelConfig`` so a config
crosses between the two packages as ``ModelConfig(**asdict(cfg))``;
``ShapeConfig``, ``SHAPES`` and ``shape_applicable`` are copies of
``src/repro/configs/base.py:74-100``, the dry run's (arch x shape) cells.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0      # leading dense layers in MoE stacks
    # local/global attention pattern (gemma3): ratio L local : 1 global
    local_window: int = 0
    local_global_ratio: int = 0
    # hybrid (zamba2): shared attention block every k SSM layers
    shared_attn_every: int = 0
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # RWKV
    rwkv_head_dim: int = 64
    # misc
    rope_theta: float = 1e4
    mrope: bool = False         # qwen2-vl M-RoPE (3D sections)
    mrope_sections: tuple = (16, 24, 24)   # t/h/w halves of head_dim
    tie_embeddings: bool = True
    modality: str = "text"      # text | vision | audio
    attn_logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    act: str = "silu"
    # serving-model parameters (L2 gateway service-time model)
    ms_per_token_decode: float = 8.0
    ms_per_ktoken_prefill: float = 30.0

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (sliding-window / SSM / hybrid)."""
        return (self.family in ("ssm", "hybrid")
                or self.local_global_ratio > 0)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The assigned input-shape set (same four for every LM arch).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch; 500k-token KV "
                       "decode requires sub-quadratic attention")
    return True, ""


@dataclass(frozen=True)
class TrainConfig:
    """Own copy of ``repro.configs.base.TrainConfig``: the same fields and
    defaults (AdamW, the cosine schedule, clipping, z-loss)."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    z_loss: float = 1e-4
    remat: str = "block"        # none | block | full
    microbatches: int = 1       # gradient accumulation
    seed: int = 0
