"""RWKV6 time-mix recurrence, returning the output and the final state.

Port of the Pallas TPU kernel ``src/repro/kernels/rwkv6_scan.py:46``.
:func:`rwkv6_scan_plain` is the plain PyTorch version (the semantics of
``repro.kernels.ref.rwkv6_scan_ref``); :func:`rwkv6_scan_cuda` launches
``csrc/rwkv6_scan.cu``. Both also return the final state, which the
Pallas kernel drops and prefill needs for the decode cache.

Layout: r, k, v, w (BH, S, hd) of one dtype, w the per-channel decay in
(0, 1); u (NU, hd) f32 the bonus, row ``bh`` reading u row ``bh % NU``
(u is per head and shared by the batch; NU = BH is the Pallas layout).
Returns o (BH, S, hd) in r's dtype and S (BH, hd, hd) f32, indexed
[key][value], from a zero initial state:
``o_t = r_t (S + diag(u) k_t^T v_t)``, then ``S <- diag(w_t) S + k_t^T v_t``.
Any S is taken: the Pallas chunk was only the TPU's tile. The kernel
computes the recurrence regrouped into chunks of :data:`CHUNK` steps,
every decay a product of w's (its source note; the arithmetic is
emulated in ``tests/test_torch_rwkv_design.py``). Where autograd records
the call it goes through :class:`RWKV6Scan`, whose backward is the
hand-written ``repro_rwkv6_scan_bwd`` (``csrc/rwkv6_scan_bwd.cu``: what
each chunk of :data:`BWD_CHUNK` steps adds to the state and to its
gradient, as products of w; a carry over the chunks for the state at
each chunk's start and its gradient at each chunk's end; then a block a
(head, chunk, rows of the state) steps its chunk forward from the
checkpoint, keeping the state every :data:`BWD_SUB` steps, and walks
those sub-chunks in reverse, recomputing their states and carrying dS
back through them; dv and du are summed over the row blocks and over
the chunks and heads that share a u row in a fixed order);
:func:`rwkv6_scan_bwd_plain` is autograd through the plain version.
Nothing divides by w, which may be exactly 0.
"""
from __future__ import annotations

import torch

from . import build, costs
from .common import (DTYPE_CODES, SCAN_HEAD_DIMS, aligned16,
                     check_kernel_tensor, needs_grad, require, skip_launch,
                     stream_of)

NAME = "rwkv6_scan"
BWD_NAME = "rwkv6_scan_bwd"
CHUNK = 16          # steps a chunk in csrc/rwkv6_scan.cu (kT)
BWD_CHUNK = 64      # steps between checkpoints in csrc/rwkv6_scan_bwd.cu (kT)
BWD_SUB = 16        # steps a sub-chunk there, its states in registers (kTs)
launches = 0
bwd_launches = 0


def bwd_rows(hd: int) -> int:
    """Rows of the state a block of the backward owns (kRB): 1024
    elements of the state a block, at most hd rows."""
    return min(hd, 1024 // hd)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    BH, S, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float().repeat(BH // u.shape[0], 1)[:, :, None]     # (BH, hd, 1)
    state = torch.zeros(BH, hd, hd, dtype=torch.float32, device=r.device)
    out = torch.empty(BH, S, hd, dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        out[:, t] = (rf[:, t, None, :] @ (state + uf * kv))[:, 0]
        state = wf[:, t, :, None] * state + kv
    return out.to(r.dtype), state


def _check(r, k, v, w, u, name=NAME) -> None:
    for arg, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        check_kernel_tensor(t, name, arg, r)
    require(r.dtype in DTYPE_CODES, name, f"dtype {r.dtype} not supported")
    require(all(t.dtype == r.dtype for t in (k, v, w)), name,
            "r, k, v and w must share a dtype")
    require(u.dtype == torch.float32, name, "u must be float32")
    require(r.dim() == 3 and all(t.shape == r.shape for t in (k, v, w)),
            name, "r, k, v and w must be (BH, S, hd) of one shape")
    BH, S, hd = r.shape
    require(hd in SCAN_HEAD_DIMS, name,
            f"head dim must be one of {SCAN_HEAD_DIMS}")
    require(u.dim() == 2 and u.shape[1] == hd and u.shape[0] >= 1
            and BH % u.shape[0] == 0, name,
            f"u must be (NU, {hd}) with BH={BH} a multiple of NU")
    require(S >= 1 and BH <= 2 ** 31 - 1, name,
            f"unsupported sizes BH={BH} S={S}")


def _forward(r, k, v, w, u):
    global launches
    _check(r, k, v, w, u)
    require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w, u)), NAME,
            "r, k, v, w and u must be 16-byte aligned")   # 16-byte copies
    BH, S, hd = r.shape
    o = torch.empty_like(r)
    state = torch.empty((BH, hd, hd), dtype=torch.float32, device=r.device)
    if skip_launch(r, NAME, lambda: costs.rwkv(BH, u.shape[0], S, hd,
                                               r.dtype, CHUNK)):
        return o, state
    rc = build.library().repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        o.data_ptr(), state.data_ptr(), BH, u.shape[0], S, hd,
        DTYPE_CODES[r.dtype], stream_of(r))
    build.check(rc, NAME)
    launches += 1
    return o, state


class RWKV6Scan(torch.autograd.Function):
    """The kernel with the hand-written backward (the inputs saved; the
    backward recomputes the states from them)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, do, dstate):
        return rwkv6_scan_bwd_cuda(*ctx.saved_tensors, do.contiguous(),
                                   dstate.contiguous())


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    if needs_grad(r, k, v, w, u):
        return RWKV6Scan.apply(r, k, v, w, u)
    return _forward(r, k, v, w, u)


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                         dstate: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du): autograd through :func:`rwkv6_scan_plain`
    for the gradients do of o and dstate of the final state."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        o, state = rwkv6_scan_plain(*ins)
        return torch.autograd.grad((o, state), ins, (do, dstate))


def rwkv6_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                        dstate: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw in r's dtype, du (NU, hd) f32) for the gradients do
    (r's shape and dtype) of o and dstate (BH, hd, hd) f32 of the final
    state: one call of ``repro_rwkv6_scan_bwd`` (the chunk summaries, the
    carry over the chunks, the chunk pass, then the sums of dv over the
    row blocks and of du over the chunks and the heads of a u row)."""
    global bwd_launches
    _check(r, k, v, w, u, BWD_NAME)
    BH, S, hd = r.shape
    check_kernel_tensor(do, BWD_NAME, "do", r)
    check_kernel_tensor(dstate, BWD_NAME, "dstate", r)
    require(do.shape == r.shape and do.dtype == r.dtype, BWD_NAME,
            "do must have r's shape and dtype")
    require(dstate.shape == (BH, hd, hd) and dstate.dtype == torch.float32,
            BWD_NAME, f"dstate must be float32 ({BH}, {hd}, {hd})")
    nrb = hd // bwd_rows(hd)
    nc = -(-S // BWD_CHUNK)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    r, k, v, w, do = (aligned16(t) for t in (r, k, v, w, do))
    # scratch: the state at each chunk's start and its gradient at each
    # chunk's end, each chunk's decay, v_t . do_t by chunk; each row
    # block's dv; each (chunk, head)'s du
    ckpt = torch.empty(BH * nc * (2 * hd * hd + hd + BWD_CHUNK), **f32)
    dv_part = torch.empty((BH, nrb, S, hd), **f32)
    du_part = torch.empty((nc, BH, hd), **f32)
    if skip_launch(r, BWD_NAME, lambda: costs.rwkv_bwd(BH, u.shape[0], S, hd,
                                                       r.dtype)):
        return dr, dk, dv, dw, du
    rc = build.library().repro_rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        do.data_ptr(), dstate.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ckpt.data_ptr(),
        dv_part.data_ptr(), du_part.data_ptr(), BH, u.shape[0], S, hd,
        DTYPE_CODES[r.dtype], stream_of(r))
    build.check(rc, BWD_NAME)
    bwd_launches += 1
    return dr, dk, dv, dw, du
