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

from . import build
from .common import (DTYPE_CODES, check_cuda_tensor, refuse_grad, require,
                     stream_of)

NAME = "ssm_scan"
STATE_DIMS = (16, 32, 64, 128)
launches = 0


def chunk_cumsum(loga: torch.Tensor, chunk: int) -> torch.Tensor:
    """The cumulative sum of ``loga`` (BH, S) along S, reset every
    ``chunk`` steps: the ``cumlog`` input of :func:`ssm_scan_plain` and
    :func:`ssm_scan_cuda`."""
    BH, S = loga.shape
    nc = -(-S // chunk)
    padded = torch.nn.functional.pad(loga, (0, nc * chunk - S))
    return padded.view(BH, nc, chunk).cumsum(-1).view(BH, -1)[:, :S] \
        .contiguous()


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
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=xbar.device))
    h = torch.zeros(BH, hd, ds, dtype=torch.float32, device=xbar.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, Bc, Cc, cm = xb[:, sl], Bf[:, sl], Cf[:, sl], cum[:, sl]
        # intra-chunk: L[i, j] = exp(cum_i - cum_j) for j <= i
        L = torch.where(tril, torch.exp(cm[:, :, None] - cm[:, None, :]),
                        0.0)
        y = ((Cc @ Bc.transpose(1, 2)) * L) @ xc
        # inter-chunk: the carried state, decayed to each position
        y = y + torch.exp(cm)[..., None] * (Cc @ h.transpose(1, 2))
        tot = cm[:, -1:]
        h = h * torch.exp(tot)[..., None] + \
            (xc * torch.exp(tot - cm)[..., None]).transpose(1, 2) @ Bc
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(xbar.dtype), h


def ssm_scan_cuda(xbar: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  cumlog: torch.Tensor, *, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    refuse_grad(NAME, xbar, B, C, cumlog)
    for arg, t in (("xbar", xbar), ("B", B), ("C", C), ("cumlog", cumlog)):
        check_cuda_tensor(t, NAME, arg)
    require(xbar.dtype == torch.float32 and cumlog.dtype == torch.float32,
            NAME, "xbar and cumlog must be float32")
    require(B.dtype in DTYPE_CODES and C.dtype == B.dtype, NAME,
            f"B and C must share a dtype of {list(DTYPE_CODES)}")
    require(xbar.dim() == 3 and B.dim() == 3 and C.shape == B.shape, NAME,
            "xbar must be (BH, S, hd), B and C (BH_bc, S, ds) of one shape")
    BH, S, hd = xbar.shape
    BHbc, Sb, ds = B.shape
    require(Sb == S and cumlog.shape == (BH, S), NAME,
            f"B, C and cumlog must cover S={S} steps")
    require(ds in STATE_DIMS, NAME, f"state dim must be one of {STATE_DIMS}")
    require(BHbc >= 1 and BH % BHbc == 0, NAME,
            f"BH={BH} must be a multiple of BH_bc={BHbc}")
    require(S >= 1 and hd >= 1 and chunk >= 1 and BH <= 2 ** 31 - 1, NAME,
            f"unsupported sizes BH={BH} S={S} hd={hd} chunk={chunk}")
    if B.dtype == torch.bfloat16:      # the tensor-core kernel's 16-byte copies
        require(hd % 4 == 0, NAME, f"bf16 B/C need hd % 4 == 0, got {hd}")
        require(all(t.data_ptr() % 16 == 0 for t in (xbar, B, C)), NAME,
                "xbar, B and C must be 16-byte aligned")
    y = torch.empty_like(xbar)
    h = torch.empty((BH, hd, ds), dtype=torch.float32, device=xbar.device)
    rc = build.library().repro_ssm_scan(
        xbar.data_ptr(), B.data_ptr(), C.data_ptr(), cumlog.data_ptr(),
        y.data_ptr(), h.data_ptr(), BH, BHbc, S, hd, ds, chunk,
        DTYPE_CODES[B.dtype], stream_of(xbar))
    build.check(rc, NAME)
    launches += 1
    return y, h
