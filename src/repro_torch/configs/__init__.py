"""repro_torch.configs — own copy of the model configuration."""
from .base import ModelConfig
from .registry import ARCHS, get_config, get_smoke

__all__ = ["ModelConfig", "ARCHS", "get_config", "get_smoke"]
