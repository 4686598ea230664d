"""Public kernel entry points of the port: dispatch by device.

Counterpart of ``repro.kernels.ops``, whose ``_auto_interpret`` picked
Pallas interpret mode off the TPU. Here a CPU tensor goes to the plain
PyTorch version and a CUDA tensor to the hand-written kernel; a CUDA
call that the kernel cannot take raises, and nothing falls back. Each
kernel module counts its own launches (``launch_counts``); a replay of a
captured CUDA graph runs no wrapper, so it adds the launches counted at
its capture (``uncounted``, ``add_launches``).

Gradients: on the card ``fused_rmsnorm``, uncapped ``flash_attention``,
``ssm_scan`` and ``rwkv6_scan`` are ``torch.autograd.Function``s whose
backward is hand-written too (its launches counted under their own
names: ``fused_rmsnorm_bwd``, ``flash_bwd_preprocess``,
``flash_bwd_dkdv``, ``flash_bwd_dq``, ``ssm_scan_bwd``,
``rwkv6_scan_bwd``); ``decode_attention`` and a capped
``flash_attention`` raise ``NotImplementedError`` where a gradient is
wanted. On the CPU autograd differentiates the plain versions.

A meta tensor (``launch/dryrun.py``) takes the card's route through the
same wrappers and Functions: each allocates and saves what its CUDA call
does, skips the launch and records its bytes and flops
(``kernels.costs``); it counts no launch.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import fused_rmsnorm as _rmsnorm
from . import mc_cell as _mc
from . import rwkv6_scan as _rwkv
from . import ssm_scan as _ssm

# every kernel's launch counter (mc_cell's entry point is mc.run_grid):
# name -> (module, attribute)
_COUNTERS = {m.NAME: (m, "launches")
             for m in (_rmsnorm, _flash, _decode, _ssm, _rwkv, _mc)}
_COUNTERS.update({m.BWD_NAME: (m, "bwd_launches")
                  for m in (_rmsnorm, _ssm, _rwkv)})
_COUNTERS.update({n: (_flash, a) for n, a in _flash.BWD_COUNTERS.items()})


def _on_card(t: torch.Tensor, name: str) -> bool:
    """The kernel's route for a CUDA tensor and for a meta tensor (the dry
    run: the same wrapper and autograd Function, the launch skipped), the
    plain version's for a CPU tensor."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    if _on_card(x, _rmsnorm.NAME):
        return _rmsnorm.fused_rmsnorm_cuda(x, w, eps=eps)
    return _rmsnorm.fused_rmsnorm_plain(x, w, eps=eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _on_card(q, _flash.NAME):
        return _flash.flash_attention_cuda(q, k, v, **kw)
    return _flash.flash_attention_plain(q, k, v, **kw)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    kw = dict(window=window, softcap=softcap)
    if _on_card(q, _decode.NAME):
        return _decode.decode_attention_cuda(q, k, v, lengths, **kw)
    return _decode.decode_attention_plain(q, k, v, lengths, **kw)


def ssm_scan(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             cumlog: torch.Tensor, *, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_card(xbar, _ssm.NAME):
        return _ssm.ssm_scan_cuda(xbar, B, C, cumlog, chunk=chunk)
    return _ssm.ssm_scan_plain(xbar, B, C, cumlog, chunk=chunk)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_card(r, _rwkv.NAME):
        return _rwkv.rwkv6_scan_cuda(r, k, v, w, u)
    return _rwkv.rwkv6_scan_plain(r, k, v, w, u)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {n: getattr(m, a) for n, (m, a) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in _COUNTERS.values():
        setattr(m, a, 0)


@contextmanager
def uncounted() -> Iterator[dict[str, int]]:
    """Takes the launches made inside the block out of the totals. Yields
    a dict that holds them, by kernel name, once the block has ended: the
    launches of one call of a graph being captured."""
    before = launch_counts()
    inside: dict[str, int] = {}
    try:
        yield inside
    finally:
        for n, (m, a) in _COUNTERS.items():
            inside[n] = getattr(m, a) - before[n]
            setattr(m, a, before[n])


def add_launches(counts: dict[str, int]) -> None:
    """Counts the launches of one replay of a captured graph (``counts``
    from :func:`uncounted` at its capture)."""
    for n, (m, a) in _COUNTERS.items():
        setattr(m, a, getattr(m, a) + counts.get(n, 0))
