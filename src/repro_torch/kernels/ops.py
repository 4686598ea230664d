"""Public kernel entry points of the port: dispatch by device.

Counterpart of ``repro.kernels.ops``, whose ``_auto_interpret`` picked
Pallas interpret mode off the TPU. Here a CPU tensor goes to the plain
PyTorch version and a CUDA tensor to the hand-written kernel; a CUDA
call that the kernel cannot take raises, and nothing falls back. Each
kernel module counts its own launches (``launch_counts``); a replay of a
captured CUDA graph runs no wrapper, so it adds the launches counted at
its capture (``uncounted``, ``add_launches``).

Gradients: on the card ``fused_rmsnorm``, ``flash_attention`` (capped
or not), ``ssm_scan`` and ``rwkv6_scan`` are ``torch.autograd.Function``s
whose backward is hand-written too (its launches counted under their own
names: ``fused_rmsnorm_bwd``, ``flash_bwd_preprocess``,
``flash_bwd_dkdv``, ``flash_bwd_dq``, ``ssm_scan_bwd``,
``rwkv6_scan_bwd``); ``decode_attention`` raises ``NotImplementedError``
where a gradient is wanted, as JAX's decode takes none. On the CPU
autograd differentiates the plain versions.

A meta tensor (``launch/dryrun.py``) takes the card's route through the
same wrappers and Functions: each allocates and saves what its CUDA call
does, skips the launch and records its bytes and flops
(``kernels.costs``); it counts no launch.

DTensors (the sharded step, ``distributed.sharding``) go through
``common.on_shards``: each rank's shards take the route above, so the
kernels launch at local shapes. The attention entries then take any
leading dims (q (..., Sq, hd), k / v (..., Sk, hd), ``decode_attention``'s
lengths (...) as q's leading dims), flattened on each rank: a flat (B *
H) dim cannot keep batch and heads both split, so the model hands them
over unflattened. Attention is split on its leading dims (batch, heads),
or, where the KV heads do not divide the model axis (qwen2-vl's 2 over
4), flash on q's heads over k and v whole, each rank reading its own KV
head (:func:`_own_kv_head`; their gradients partial sums, reduced where
k and v were gathered), and decode over a cache split on its sequence
(:func:`_decode_on_sequence`: q whole on every rank, each rank's slice
of the cache through the kernel's log-sum-exp route, the ranks' (o, lse)
all-gathered and merged by ``decode_attention.combine_splits``, the
partial-softmax collective XLA inserts for JAX); the norm on rows with d whole (its weight replicated, its gradient a
partial sum reduced across the row shards), and the scans on their heads
(:func:`_scan_on_heads`: (B, nh, S, hd) with S and hd whole; ssm's B and
C, rwkv6's u, shared by the heads, replicated and cut: their gradients
partial sums reduced where they are used). A split a kernel cannot take
raises; nothing falls back to a plain version.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

from ..distributed.sharding import is_dtensor, on_local, place
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import fused_rmsnorm as _rmsnorm
from . import mc_cell as _mc
from . import rwkv6_scan as _rwkv
from . import ssm_scan as _ssm
from .common import note_call, on_shards, require

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
    if is_dtensor(x):
        return on_shards(_rmsnorm.NAME, fused_rmsnorm, (x, w),
                         whole=((-1,), (0,)), kw=dict(eps=eps))
    if _on_card(x, _rmsnorm.NAME):
        return _rmsnorm.fused_rmsnorm_cuda(x, w, eps=eps)
    return _rmsnorm.fused_rmsnorm_plain(x, w, eps=eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    kw = dict(causal=causal, window=window, softcap=softcap)
    if is_dtensor(q):
        return on_shards(_flash.NAME, flash_attention, (q, k, v),
                         whole=((-2, -1),) * 3, kw=kw,
                         cut=_own_kv_head(_flash.NAME, q, k, v))
    if q.dim() > 3:
        return flash_attention(q.flatten(0, -3), k.flatten(0, -3),
                               v.flatten(0, -3), **kw).view(q.shape)
    if _on_card(q, _flash.NAME):
        return _flash.flash_attention_cuda(q, k, v, **kw)
    return _flash.flash_attention_plain(q, k, v, **kw)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    kw = dict(window=window, softcap=softcap)
    if is_dtensor(q):
        if any(p.is_shard(k.ndim - 2) for p in k.placements):
            return _decode_on_sequence(q, k, v, lengths, **kw)
        return on_shards(_decode.NAME, decode_attention, (q, k, v, lengths),
                         whole=((-2, -1), (-2, -1), (-2, -1), ()), kw=kw)
    return _decode_flat(q, k, v, lengths, **kw)


def _decode_flat(q, k, v, lengths, **kw):
    """decode on plain tensors, the leading dims flattened to the kernel's
    rows; with ``with_lse`` the pair (o (q's shape, f32), lse (q's
    leading dims))."""
    if q.dim() > 3:
        got = _decode_flat(q.flatten(0, -3), k.flatten(0, -3),
                           v.flatten(0, -3), lengths.flatten(), **kw)
        if kw.get("with_lse"):
            return got[0].view(q.shape), got[1].view(q.shape[:-2])
        return got.view(q.shape)
    if _on_card(q, _decode.NAME):
        return _decode.decode_attention_cuda(q, k, v, lengths, **kw)
    return _decode.decode_attention_plain(q, k, v, lengths, **kw)


def _own_kv_head(name: str, q, k, v):
    """The ``on_shards`` cut of attention whose q (B, H, S, hd) is split
    on its heads over a mesh dim on which k and v (B, KV, S, hd) are whole
    (the KV heads do not divide that dim: the model gathered them): each
    rank's H / n query heads lie in one GQA group of G = H / KV, and the
    kernel takes that group's KV head, k[:, c H / n // G] on the rank at
    coordinate c, so that it runs its group inside. None where no dim
    splits q's heads over whole k and v."""
    mesh = q.device_mesh
    at = [m for m, (pq, pk) in enumerate(zip(q.placements, k.placements))
          if pq.is_shard(1) and pk.is_replicate()]
    if not at:
        return None
    H, KV = q.shape[1], k.shape[1]
    require(q.ndim == 4 and len(at) == 1 and v.placements == k.placements,
            name, f"q {tuple(q.shape)} {q.placements} over k "
            f"{tuple(k.shape)} {k.placements}: one mesh dim may split the "
            "query heads over whole KV heads, q (B, H, S, hd)")
    n = mesh.size(at[0])
    per, group = H // n, H // KV
    require(H % KV == 0 and group % per == 0, name,
            f"{per} query heads a rank do not lie in one group of {group}")
    j = mesh.get_local_rank(at[0]) * per // group

    def cut(q, k, v):
        return q, k[:, j:j + 1].contiguous(), v[:, j:j + 1].contiguous()
    return cut


def _decode_on_sequence(q, k, v, lengths, *, window: int, softcap: float):
    """Decode over a cache (B, KV, S, hd) split on its sequence over one
    mesh dim (JAX's ``kv_seq``, where the KV heads do not divide the model
    axis): q (B, H, 1, hd) and lengths (B, H) whole on that dim, any other
    dim splitting the batch of all four alike or none. The rank at
    coordinate c holds slots c S_l .. (c + 1) S_l - 1 of each row; the live
    keys are the prefix 0 .. len - 1, so its slice's lengths are
    clamp(len - c S_l, 0, S_l) and the kernel's ``key < length`` mask holds
    there. Each rank's (o, lse) pair (the kernel's ``with_lse`` route) is
    all-gathered over the dim in one tensor and merged in rank order
    (``decode_attention.combine_splits``) into q's dtype: the output
    placed as q."""
    from torch.distributed.tensor import Replicate, Shard
    name = _decode.NAME
    mesh = k.device_mesh
    at = [m for m, p in enumerate(k.placements) if p.is_shard(k.ndim - 2)]
    require(window == 0, name, "a window over a cache split on its "
            "sequence (no config has one)")
    require(len(at) == 1 and v.placements == k.placements, name,
            f"the cache {tuple(k.shape)} is placed {k.placements}: one mesh "
            "dim may split its sequence")
    m = at[0]
    require(q.ndim == 4 and q.placements[m].is_replicate()
            and lengths.placements[m].is_replicate(), name,
            f"q {tuple(q.shape)} {q.placements} must be (B, H, 1, hd), "
            f"whole on mesh dim {m}, which splits the cache's sequence")
    for j in range(mesh.ndim):
        pl = {t.placements[j] for t in (q, k, lengths)}
        require(j == m or (len(pl) == 1 and pl <= {Replicate(), Shard(0)}),
                name, f"mesh dim {j} splits q, the cache and the lengths "
                f"otherwise than on their batch ({q.placements}, "
                f"{k.placements}, {lengths.placements})")
    require(k.shape[-2] % mesh.size(m) == 0, name,
            f"{k.shape[-2]} slots do not split {mesh.size(m)} ways")
    c = mesh.get_local_rank(m)
    hd = q.shape[-1]
    kw = dict(window=0, softcap=softcap, with_lse=True)

    def local(q, k, v, lengths):
        n = k.shape[-2]
        lengths = (lengths - c * n).clamp(0, n).to(torch.int32)
        note_call(name, (q, k, v, lengths), kw)
        o, lse = _decode_flat(q, k, v, lengths, **kw)
        return torch.cat([o, lse[..., None, None]], dim=-1)[None]

    def shifted(p):
        return Shard(p.dim + 1) if p.is_shard() else p
    shape = (mesh.size(m), *q.shape[:-1], hd + 1)
    parts = on_local(local, (q, k, v, lengths), ((shape, tuple(
        Shard(0) if j == m else shifted(p)
        for j, p in enumerate(q.placements))),))[0]
    parts = place(parts, [Replicate() if j == m else p
                          for j, p in enumerate(parts.placements)])
    return on_local(lambda t: _decode.combine_splits(t[..., :hd], t[..., hd],
                                                     q.dtype),
                    (parts,), ((q.shape, tuple(q.placements)),))[0]


def ssm_scan(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             cumlog: torch.Tensor, *, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """xbar (..., S, hd), cumlog (..., S): the leading dims flattened to
    the kernel's rows, B and C (BH_bc, S, ds) read by each group of
    consecutive rows. Returns y (..., S, hd) and h (..., hd, ds). On
    DTensors xbar is (B, nh, S, hd), split on the batch and the heads,
    cumlog (B, nh, S) split as xbar, B and C (B, S, ds) with the batch
    split as xbar's and replicated elsewhere (the heads' shared group: its
    gradient a partial sum over the head split)."""
    if is_dtensor(xbar):
        return _scan_on_heads(_ssm.NAME, ssm_scan, (xbar, B, C, cumlog),
                              shared=(1, 2), state=B.shape[-1], chunk=chunk)
    if xbar.dim() > 3:
        lead, (S, hd) = xbar.shape[:-2], xbar.shape[-2:]
        y, h = ssm_scan(xbar.reshape(-1, S, hd), B, C,
                        cumlog.reshape(-1, S), chunk=chunk)
        return y.view(*lead, S, hd), h.view(*lead, hd, h.shape[-1])
    if _on_card(xbar, _ssm.NAME):
        return _ssm.ssm_scan_cuda(xbar, B, C, cumlog, chunk=chunk)
    return _ssm.ssm_scan_plain(xbar, B, C, cumlog, chunk=chunk)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (..., S, hd), the leading dims flattened to the kernel's
    rows, u (NU, hd) read by row % NU. Returns o (..., S, hd) and the
    state (..., hd, hd). On DTensors r, k, v and w are (B, nh, S, hd),
    split on the batch and the heads, and u (nh, hd) is cut to the rank's
    heads (its gradient a partial sum over a batch split)."""
    if is_dtensor(r):
        return _scan_on_heads(_rwkv.NAME, rwkv6_scan, (r, k, v, w, u),
                              heads=(4,), state=r.shape[-1])
    if r.dim() > 3:
        lead, (S, hd) = r.shape[:-2], r.shape[-2:]
        o, state = rwkv6_scan(*(t.reshape(-1, S, hd) for t in (r, k, v, w)),
                              u)
        return o.view(*lead, S, hd), state.view(*lead, hd, hd)
    if _on_card(r, _rwkv.NAME):
        return _rwkv.rwkv6_scan_cuda(r, k, v, w, u)
    return _rwkv.rwkv6_scan_plain(r, k, v, w, u)


def _scan_on_heads(name: str, fn, args, *, state: int, shared=(),
                   heads=(), **kw):
    """A scan on each rank's heads (``common.on_shards``): ``args[0]``
    (B, nh, S, hd) split on its batch and heads only; every other
    argument of its leading dims is placed as it is (cumlog, r, k, v,
    w), one of ``shared`` (B, S, ds) on its batch split and replicated
    elsewhere, one of ``heads`` (nh, hd) on its head split and replicated
    elsewhere: a replicated input is cut, which moves nothing, and an
    input split otherwise raises. Returns the output (args[0]'s shape and
    placements) and the final state (B, nh, hd, ``state``) placed as
    args[0]'s leading dims."""
    from torch.distributed.tensor import Replicate, Shard

    from .common import require
    x = args[0]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    cut = [Shard(0) if p.is_shard(1) else Replicate() for p in x.placements]
    placed = []
    for i, a in enumerate(args):
        want = (rows if i in shared else cut if i in heads
                else list(x.placements))
        for p, w in zip(a.placements, want):
            require(p == w or p.is_replicate(), name,
                    f"argument {i} of shape {tuple(a.shape)} is placed "
                    f"{a.placements}, not as the scan's heads ({want})")
        placed.append(place(a, want))
    whole = [(1, 2) if i in shared else (1,) if i in heads
             else tuple(range(2, a.ndim)) for i, a in enumerate(args)]
    B, nh, S, hd = x.shape
    out = (tuple(x.shape), tuple(x.placements))
    last = ((B, nh, hd, state), tuple(x.placements))
    return on_shards(name, fn, placed, whole=whole, kw=kw, outs=(out, last))


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
