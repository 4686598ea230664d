"""repro_torch.models — the port's model code (dense uniform stacks, the
zamba hybrid and rwkv)."""
from .layers import MLP, Attention, apply_rope, attention, mlp, rmsnorm
from .transformer import LM, family_kind

__all__ = ["MLP", "Attention", "apply_rope", "attention", "mlp", "rmsnorm",
           "LM", "family_kind"]
