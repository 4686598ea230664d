"""repro_torch.configs — own copy of the model configuration and shapes."""
from .base import (SHAPES, ModelConfig, ShapeConfig, TrainConfig,
                   shape_applicable)
from .registry import ARCHS, all_cells, get_config, get_smoke

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "TrainConfig",
           "shape_applicable", "ARCHS", "all_cells", "get_config",
           "get_smoke"]
