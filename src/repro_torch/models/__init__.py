"""repro_torch.models — the port's model code (dense uniform stacks, the
zamba hybrid and rwkv; the vision and audio frontend stubs)."""
from .layers import (MLP, Attention, apply_mrope, apply_rope, attention, mlp,
                     moe, rmsnorm)
from .ssm import ssm_block, ssm_decode, ssm_dims, ssm_init_state
from .rwkv import rwkv_block, rwkv_dims, rwkv_init_state
from .transformer import LM, cache_specs, family_kind, lg_groups, zamba_groups
from . import frontends

__all__ = ["MLP", "Attention", "apply_mrope", "apply_rope", "attention",
           "mlp", "moe", "rmsnorm", "ssm_block", "ssm_decode", "ssm_dims",
           "ssm_init_state", "rwkv_block", "rwkv_dims", "rwkv_init_state",
           "LM", "cache_specs", "family_kind", "lg_groups", "zamba_groups",
           "frontends"]
