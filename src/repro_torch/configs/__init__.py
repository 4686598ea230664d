"""repro_torch.configs — own copy of the model configuration and shapes."""
from .base import (SHAPES, ModelConfig, ShapeConfig, TrainConfig,
                   shape_applicable)
from .registry import ARCHS, get_config, get_smoke

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "TrainConfig",
           "shape_applicable", "ARCHS", "get_config", "get_smoke"]
