"""The plain PyTorch versions under the names of :mod:`.ops`, for running
the model's path without the kernels on any device (the on-card check
of the kernel path against the plain path)."""
from .decode_attention import decode_attention_plain as decode_attention
from .flash_attention import flash_attention_plain as flash_attention
from .fused_rmsnorm import fused_rmsnorm_plain as fused_rmsnorm
from .rwkv6_scan import rwkv6_scan_plain as rwkv6_scan
from .ssm_scan import ssm_scan_plain as ssm_scan

__all__ = ["decode_attention", "flash_attention", "fused_rmsnorm",
           "rwkv6_scan", "ssm_scan"]
