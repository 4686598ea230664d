"""Mamba2 (SSD) selective scan, returning the output and the final state.

Port of the Pallas TPU kernel ``src/repro/kernels/ssm_scan.py:49``.
:func:`ssm_scan_plain` is the plain PyTorch version (the semantics of
``repro.kernels.ref.ssm_scan_ref``, computed in the chunked SSD form of
``repro.models.ssm.ssm_block``); :func:`ssm_scan_cuda` launches
``csrc/ssm_scan.cu``, whose C entry picks the kernel by the dtype of B/C:
bf16 (the serving path's) runs the chunked form on the tensor cores in
3xTF32, each f32 operand split into two TF32 terms (hd a multiple of 4,
16-byte aligned inputs), f32 the recurrence on CUDA cores (the checking
path). Both also return the final state ``h``,
which the Pallas kernel drops and prefill needs for the decode cache.
Where autograd records the call it goes through :class:`SSMScan`, whose
backward is the hand-written ``repro_ssm_scan_bwd``
(``csrc/ssm_scan_bwd.cu``: each chunk's own state terms and C B^T once
a B/C group on the tensor cores, the states at the chunk starts and
their gradients carried over the chunks, then a block a (head, chunk)
forming dxbar, dB, dC and dcumlog in one sweep of 64-step tiles, every
product in 3xTF32, dB/dC summed over the heads of a group in a fixed
order); :func:`ssm_scan_bwd_plain` is autograd
through the plain version. The exponent's argument is masked (j <= i)
before ``exp`` in both, so the gradient stays finite where a chunk's
log-decay spans more than ~88 (the Pallas kernel and JAX's
``ssm_block`` mask after it, and their gradient is NaN there).

Layout: xbar (BH, S, hd) f32 dt-weighted inputs; B, C (BH_bc, S, ds) with
BH a multiple of BH_bc, row ``bh`` reading B/C row ``bh // (BH // BH_bc)``
(the heads of a sequence share one B/C group); cumlog (BH, S) f32, the
cumulative log-decay reset every ``chunk`` steps. S need not be a chunk
multiple: a short last chunk is the same function as one padded with zero
inputs and zero log-decay. Returns y (BH, S, hd) f32 and h (BH, hd, ds)
f32, from a zero initial state.
"""
from __future__ import annotations

import torch

from . import build, costs
from .common import (DTYPE_CODES, aligned16, check_kernel_tensor, needs_grad,
                     require, skip_launch, stream_of)

NAME = "ssm_scan"
BWD_NAME = "ssm_scan_bwd"
STATE_DIMS = (16, 32, 64, 128)
BWD_MAX_HD = 128    # the backward's head dim, padded to 64 or 128 (HP)
BWD_TILE = 64       # steps a tile in csrc/ssm_scan_bwd.cu (kT)
launches = 0
bwd_launches = 0


def chunk_cumsum(loga: torch.Tensor, chunk: int) -> torch.Tensor:
    """The cumulative sum of ``loga`` (..., S) along S, reset every
    ``chunk`` steps: the ``cumlog`` input of :func:`ssm_scan_plain` and
    :func:`ssm_scan_cuda` (a DTensor split on its leading dims only stays
    so)."""
    *lead, S = loga.shape
    nc = -(-S // chunk)
    padded = torch.nn.functional.pad(loga, (0, nc * chunk - S))
    return padded.view(*lead, nc, chunk).cumsum(-1).view(*lead, -1)[..., :S] \
        .contiguous()


def bwd_scratch_floats(BH: int, BH_bc: int, S: int, hd: int, ds: int,
                       chunk: int) -> int:
    """The backward's f32 workspace: the state at each chunk's start and
    its gradient at each chunk's end (BH, nc, hd, ds) each, then C B^T of
    each (B/C group, chunk) as the 64 x 64 tiles on and below the
    diagonal of the longest chunk."""
    nc = -(-S // chunk)
    nt = -(-min(chunk, S) // BWD_TILE)
    return 2 * BH * nc * hd * ds + \
        BH_bc * nc * (nt * (nt + 1) // 2) * BWD_TILE ** 2


def ssm_scan_plain(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   cumlog: torch.Tensor, *, chunk: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    BH, S, hd = xbar.shape
    ds = B.shape[-1]
    group = BH // B.shape[0]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xb = xbar.float()
    Bf = B.float().repeat_interleave(group, dim=0)
    Cf = C.float().repeat_interleave(group, dim=0)
    cum = cumlog.float()
    if pad:
        # zero inputs; the cum of the last chunk stays at its last value
        xb = torch.nn.functional.pad(xb, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
        cum = torch.cat([cum, cum[:, -1:].expand(BH, pad)], dim=1)
    above = ~torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=xbar.device))
    h = torch.zeros(BH, hd, ds, dtype=torch.float32, device=xbar.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, Bc, Cc, cm = xb[:, sl], Bf[:, sl], Cf[:, sl], cum[:, sl]
        # intra-chunk: L[i, j] = exp(cum_i - cum_j) for j <= i, the
        # argument masked to -inf above the diagonal before exp (exp of it
        # can overflow there, and the gradient of a mask after exp is
        # 0 * inf = NaN); exp(-inf) = 0, so y is what a mask after gives
        L = torch.exp((cm[:, :, None] - cm[:, None, :])
                      .masked_fill(above, float("-inf")))
        y = ((Cc @ Bc.transpose(1, 2)) * L) @ xc
        # inter-chunk: the carried state, decayed to each position
        y = y + torch.exp(cm)[..., None] * (Cc @ h.transpose(1, 2))
        tot = cm[:, -1:]
        h = h * torch.exp(tot)[..., None] + \
            (xc * torch.exp(tot - cm)[..., None]).transpose(1, 2) @ Bc
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(xbar.dtype), h


def _check(xbar, B, C, cumlog, chunk, name=NAME) -> None:
    for arg, t in (("xbar", xbar), ("B", B), ("C", C), ("cumlog", cumlog)):
        check_kernel_tensor(t, name, arg, xbar)
    require(xbar.dtype == torch.float32 and cumlog.dtype == torch.float32,
            name, "xbar and cumlog must be float32")
    require(B.dtype in DTYPE_CODES and C.dtype == B.dtype, name,
            f"B and C must share a dtype of {list(DTYPE_CODES)}")
    require(xbar.dim() == 3 and B.dim() == 3 and C.shape == B.shape, name,
            "xbar must be (BH, S, hd), B and C (BH_bc, S, ds) of one shape")
    BH, S, hd = xbar.shape
    BHbc, Sb, ds = B.shape
    require(Sb == S and cumlog.shape == (BH, S), name,
            f"B, C and cumlog must cover S={S} steps")
    require(ds in STATE_DIMS, name, f"state dim must be one of {STATE_DIMS}")
    require(BHbc >= 1 and BH % BHbc == 0, name,
            f"BH={BH} must be a multiple of BH_bc={BHbc}")
    require(S >= 1 and hd >= 1 and chunk >= 1 and BH <= 2 ** 31 - 1, name,
            f"unsupported sizes BH={BH} S={S} hd={hd} chunk={chunk}")


def _forward(xbar, B, C, cumlog, chunk):
    global launches
    _check(xbar, B, C, cumlog, chunk)
    BH, S, hd = xbar.shape
    BHbc, _, ds = B.shape
    if B.dtype == torch.bfloat16:      # the tensor-core kernel's 16-byte copies
        require(hd % 4 == 0, NAME, f"bf16 B/C need hd % 4 == 0, got {hd}")
        require(all(t.data_ptr() % 16 == 0 for t in (xbar, B, C)), NAME,
                "xbar, B and C must be 16-byte aligned")
    y = torch.empty_like(xbar)
    h = torch.empty((BH, hd, ds), dtype=torch.float32, device=xbar.device)
    if skip_launch(xbar, NAME, lambda: costs.ssm(BH, BHbc, S, hd, ds, chunk,
                                                 B.dtype)):
        return y, h
    rc = build.library().repro_ssm_scan(
        xbar.data_ptr(), B.data_ptr(), C.data_ptr(), cumlog.data_ptr(),
        y.data_ptr(), h.data_ptr(), BH, BHbc, S, hd, ds, chunk,
        DTYPE_CODES[B.dtype], stream_of(xbar))
    build.check(rc, NAME)
    launches += 1
    return y, h


class SSMScan(torch.autograd.Function):
    """The kernel with the hand-written backward (the inputs saved; the
    backward recomputes the chunk states from them)."""

    @staticmethod
    def forward(ctx, xbar, B, C, cumlog, chunk):
        ctx.save_for_backward(xbar, B, C, cumlog)
        ctx.chunk = chunk
        return _forward(xbar, B, C, cumlog, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        xbar, B, C, cumlog = ctx.saved_tensors
        grads = ssm_scan_bwd_cuda(xbar, B, C, cumlog, dy.contiguous(),
                                  dh.contiguous(), chunk=ctx.chunk)
        return (*grads, None)


def ssm_scan_cuda(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  cumlog: torch.Tensor, *, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if needs_grad(xbar, B, C, cumlog):
        return SSMScan.apply(xbar, B, C, cumlog, chunk)
    return _forward(xbar, B, C, cumlog, chunk)


def ssm_scan_bwd_plain(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       cumlog: torch.Tensor, dy: torch.Tensor,
                       dh: torch.Tensor, *, chunk: int
                       ) -> tuple[torch.Tensor, ...]:
    """(dxbar, dB, dC, dcumlog): autograd through :func:`ssm_scan_plain`
    for the gradients dy of y and dh of the final state."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (xbar, B, C, cumlog)]
        y, h = ssm_scan_plain(*ins, chunk=chunk)
        return torch.autograd.grad((y, h), ins, (dy, dh))


def ssm_scan_bwd_cuda(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                      cumlog: torch.Tensor, dy: torch.Tensor,
                      dh: torch.Tensor, *, chunk: int
                      ) -> tuple[torch.Tensor, ...]:
    """(dxbar f32, dB and dC in B's dtype, dcumlog f32) for the gradients
    dy (BH, S, hd) f32 of y and dh (BH, hd, ds) f32 of the final state:
    one call of ``repro_ssm_scan_bwd`` (the prep pass, the carry over the
    chunks, the chunk pass and the sums over the heads of a group). A
    head dim that is not a multiple of 4 is padded with zero columns,
    which add nothing to any gradient, and dropped from dxbar."""
    global bwd_launches
    _check(xbar, B, C, cumlog, chunk, BWD_NAME)
    BH, S, hd = xbar.shape
    BHbc, _, ds = B.shape
    check_kernel_tensor(dy, BWD_NAME, "dy", xbar)
    check_kernel_tensor(dh, BWD_NAME, "dh", xbar)
    require(dy.shape == xbar.shape and dy.dtype == torch.float32, BWD_NAME,
            "dy must be float32 of xbar's shape")
    require(dh.shape == (BH, hd, ds) and dh.dtype == torch.float32, BWD_NAME,
            f"dh must be float32 ({BH}, {hd}, {ds})")
    require(hd <= BWD_MAX_HD, BWD_NAME,
            f"head dim must be at most {BWD_MAX_HD}, got {hd}")
    nc = -(-S // chunk)
    require(nc <= 65535, BWD_NAME, f"at most 65535 chunks, got {nc}")
    pad = -hd % 4
    if pad:
        xbar, dy = (torch.nn.functional.pad(t, (0, pad)) for t in (xbar, dy))
        dh = torch.nn.functional.pad(dh, (0, 0, 0, pad))
    xbar, B, C, dy = (aligned16(t) for t in (xbar, B, C, dy))
    f32 = dict(dtype=torch.float32, device=xbar.device)
    dxbar = torch.empty_like(xbar)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dcum = torch.empty_like(cumlog)
    # scratch: the chunks' states, their gradients and C B^T; each head's
    # dB, dC before the sum over its group
    states = torch.empty(bwd_scratch_floats(BH, BHbc, S, hd + pad, ds, chunk),
                         **f32)
    partial = torch.empty((2, BH, S, ds), **f32)
    if skip_launch(xbar, BWD_NAME, lambda: costs.ssm_bwd(
            BH, BHbc, S, hd, ds, chunk, B.dtype)):
        return (dxbar[..., :hd].contiguous() if pad else dxbar), dB, dC, dcum
    rc = build.library().repro_ssm_scan_bwd(
        xbar.data_ptr(), B.data_ptr(), C.data_ptr(), cumlog.data_ptr(),
        dy.data_ptr(), dh.data_ptr(), dxbar.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dcum.data_ptr(), states.data_ptr(),
        partial.data_ptr(), BH, BHbc, S, hd + pad, ds, chunk,
        DTYPE_CODES[B.dtype], stream_of(xbar))
    build.check(rc, BWD_NAME)
    bwd_launches += 1
    if pad:
        dxbar = dxbar[..., :hd].contiguous()
    return dxbar, dB, dC, dcum
