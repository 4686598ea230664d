"""repro_torch.checkpoint — atomic, hashed, auto-resuming checkpoints in
the JAX package's format."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
