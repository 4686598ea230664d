"""Gradient compression with error feedback (counterpart of
``repro.distributed.compression``).

int8 symmetric quantization per tensor with an error accumulator:
compress(g + e) -> q; e' = (g + e) - dequant(q); ``compress_topk`` keeps
the largest-|g| fraction instead. Rounding is half to even
(``torch.round``, as ``jnp.round``); top-k ties go to the lower index,
as ``jax.lax.top_k``'s, by a stable descending sort (``torch.topk``
orders ties arbitrarily).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def init_error(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress_int8(g: torch.Tensor, e: torch.Tensor):
    """Returns (q int8, scale, new_error)."""
    corrected = g.float() + e
    scale = torch.clamp(corrected.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127) \
        .to(torch.int8)
    deq = q.float() * scale
    return q, scale, corrected - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_topk(g: torch.Tensor, e: torch.Tensor, frac: float = 0.05):
    """Keep the top-|frac| entries (flattened); returns (values, idx,
    new_error)."""
    corrected = (g.float() + e).reshape(-1)
    k = max(int(corrected.numel() * frac), 1)
    idx = torch.sort(corrected.abs(), descending=True,
                     stable=True).indices[:k]
    kept = corrected[idx]
    deq = torch.zeros_like(corrected).index_put_((idx,), kept)
    return kept, idx, (corrected - deq).reshape(g.shape)


def compressed_tree_allreduce(grads: dict, errors: dict,
                              group: Optional[object] = None):
    """Error-feedback int8 all-reduce over a dict of gradients: with a
    ``torch.distributed`` process group the dequantised gradients are
    averaged over it; without one (a single process) the reduction is
    the identity and only the quantization error path runs. Returns
    (gradients, errors)."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        q, scale, e2 = compress_int8(g, errors[name])
        deq = decompress_int8(q, scale)
        if group is not None:
            dist.all_reduce(deq, group=group)
            deq = deq / dist.get_world_size(group)
        out_g[name], out_e[name] = deq.to(g.dtype), e2
    return out_g, out_e
