"""repro_torch.configs — own copy of the model configuration."""
from .base import ModelConfig, TrainConfig
from .registry import ARCHS, get_config, get_smoke

__all__ = ["ModelConfig", "TrainConfig", "ARCHS", "get_config", "get_smoke"]
