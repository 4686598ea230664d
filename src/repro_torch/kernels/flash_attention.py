"""Blocked online-softmax attention for prefill.

Port of the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:77``.
:func:`flash_attention_plain` is the plain PyTorch version (the semantics
of ``repro.kernels.ref.flash_attention_ref``: one dense softmax);
:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``, whose
entry picks its kernel by dtype: bf16 runs on the tensor cores (P rounded
to bf16 for P V), f32 on the CUDA cores (the f32 checking path). Head
dims are ``common.HEAD_DIMS``; an hd that is not a multiple of 16 (168)
is padded to one inside the bf16 kernel only (zero columns in shared
memory, never stored), so no tensor is padded or copied outside it.

Layout: q (BH, Sq, hd), k/v (BH_kv, Sk, hd) with BH a multiple of BH_kv;
q row ``bh`` attends to k/v row ``bh // (BH // BH_kv)``. The causal mask
uses absolute indices from 0 (``k <= q``), as the Pallas kernel does; a
window W keeps keys ``k > q - W``. A ``softcap`` c > 0 caps each scaled
score s to ``c * tanh(s / c)`` before the mask, as the JAX model's
attention does (``repro.models.layers._softcap``); the Pallas kernel has
no cap.

Where autograd records a call it goes through :class:`FlashAttention`:
the forward kernel also writes each row's log-sum-exp, and the backward
is three hand-written kernels (``csrc/flash_attention_bwd.cu``):
:func:`flash_bwd_preprocess_cuda` (D = rowsum(dO * O)),
:func:`flash_bwd_dkdv_cuda` (dK, dV over key tiles, GQA summed inside)
and :func:`flash_bwd_dq_cuda` (dQ over query tiles), with no float
atomics. The source picks the dK/dV and dQ kernels by (dtype, hd): bf16
at hd 16, 32, 64 and 128 runs them on the tensor cores (64-row tiles, P
and dS rounded to bf16 before their products); f32 at any hd, and bf16
at hd 168 and 240, run the SIMT kernels (f32 FMAs, 32-row tiles), the
f32 ones being the checking path. That is a dispatch, not a fallback:
each (dtype, hd) has one kernel, and a failed launch raises. A capped
call has no backward kernel and raises where a gradient is wanted.
:func:`flash_attention_bwd_plain` is autograd through the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, costs
from .common import (DTYPE_CODES, HEAD_DIMS, check_kernel_tensor, needs_grad,
                     require, skip_launch, stream_of)

NAME = "flash_attention"
PRE_NAME, DKDV_NAME, DQ_NAME = ("flash_bwd_preprocess", "flash_bwd_dkdv",
                                "flash_bwd_dq")
NEG_INF = -1e30
launches = 0
pre_launches = dkdv_launches = dq_launches = 0
#: launch-count name -> counter attribute of the backward kernels
BWD_COUNTERS = {PRE_NAME: "pre_launches", DKDV_NAME: "dkdv_launches",
                DQ_NAME: "dq_launches"}


def softcap_scores(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """``_softcap`` of the JAX model: ``c * tanh(s / c)`` for a cap c > 0,
    s unchanged at 0."""
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   window: int, softcap: float) -> torch.Tensor:
    """The scaled, capped scores (BH, Sq, Sk) in f32, NEG_INF where
    masked."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    kf = k.float().repeat_interleave(BH // k.shape[0], dim=0)
    s = softcap_scores(torch.matmul(q.float(), kf.transpose(1, 2))
                       / math.sqrt(hd), softcap)
    q_idx = torch.arange(Sq, device=q.device)[:, None]
    k_idx = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if window > 0:
        mask &= k_idx > q_idx - window
    return torch.where(mask, s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    vf = v.float().repeat_interleave(q.shape[0] // v.shape[0], dim=0)
    p = torch.softmax(_masked_scores(q, k, causal, window, softcap), dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def _check_qkv(q, k, v, name=NAME):
    for arg, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_tensor(t, name, arg, q)
        require(t.dim() == 3, name, f"{arg} must be 3-D, got {tuple(t.shape)}")
        require(t.data_ptr() % 16 == 0, name,      # 16-byte async copies
                f"{arg} must be 16-byte aligned")
    require(q.dtype in DTYPE_CODES, name, f"dtype {q.dtype} not supported")
    require(k.dtype == q.dtype and v.dtype == q.dtype, name,
            "q, k and v must share a dtype")
    BH, Sq, hd = q.shape
    BHkv, Sk, hdk = k.shape
    require(v.shape == k.shape, name, "k and v must have one shape")
    require(hdk == hd and hd in HEAD_DIMS, name,
            f"head dim must match and be one of {HEAD_DIMS}")
    require(BHkv >= 1 and BH % BHkv == 0, name,
            f"BH={BH} must be a multiple of BH_kv={BHkv}")
    require(Sq >= 1 and Sk >= 1 and BH <= 65535 and Sq <= 65535 * 64, name,
            f"unsupported sizes BH={BH} Sq={Sq} Sk={Sk}")


def _forward(q, k, v, causal, window, softcap, out, lse):
    global launches
    BH, Sq, hd = q.shape
    BHkv, Sk, _ = k.shape
    if skip_launch(q, NAME, lambda: costs.flash(
            BH, BHkv, Sq, Sk, hd, q.dtype, causal, window, lse is not None)):
        return out
    rc = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), BH, BHkv, Sq, Sk, hd,
        int(causal), window, softcap, DTYPE_CODES[q.dtype], stream_of(q))
    build.check(rc, NAME)
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The forward kernel (with its log-sum-exp) and the three backward
    kernels; q, k, v, o and lse saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        _forward(q, k, v, causal, window, 0.0, out, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_bwd_preprocess_cuda(out, dout)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dk, dv = flash_bwd_dkdv_cuda(q, k, v, dout, lse, delta, **kw)
        dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out``, if given, is a contiguous tensor of q's shape, dtype and
    device that the kernel writes in place (and returns); by default a
    new one. Where autograd records the call (an input requires grad) it
    runs as :class:`FlashAttention`; a capped call then raises, having no
    backward kernel, and so does an ``out``."""
    grad = needs_grad(q, k, v)
    if grad and softcap > 0:
        raise NotImplementedError(
            f"{NAME}: no backward kernel for a logit softcap; a gradient "
            "through a capped call is not supported on the card")
    _check_qkv(q, k, v)
    require(window >= 0, NAME, "window must be >= 0")
    require(softcap >= 0, NAME, "softcap must be >= 0")
    if grad:
        require(out is None, NAME, "out= takes no gradient")
        return FlashAttention.apply(q, k, v, bool(causal), int(window))
    if out is None:
        out = torch.empty_like(q)
    else:
        check_kernel_tensor(out, NAME, "out", q)
        require(out.shape == q.shape and out.dtype == q.dtype
                and out.data_ptr() % 16 == 0, NAME,
                "out must have q's shape and dtype and be 16-byte aligned")
    return _forward(q, k, v, causal, window, softcap, out, None)


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse (BH, Sq) f32): the forward kernel with its natural
    log-sum-exp of each row's scaled scores written out."""
    _check_qkv(q, k, v)
    require(window >= 0 and softcap >= 0, NAME,
            "window and softcap must be >= 0")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _forward(q, k, v, causal, window, softcap, out, lse)
    return out, lse


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled, capped, masked scores (BH,
    Sq) f32, as the plain version computes them."""
    return torch.logsumexp(_masked_scores(q, k, causal, window, softcap),
                           dim=-1)


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True,
                              window: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv): autograd through :func:`flash_attention_plain`."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_plain(qg, kg, vg, causal=causal, window=window)
        return torch.autograd.grad(out, (qg, kg, vg), dout)


def flash_bwd_preprocess_plain(out: torch.Tensor, dout: torch.Tensor
                               ) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, (BH, Sq)."""
    return (dout.float() * out.float()).sum(-1)


def flash_bwd_preprocess_cuda(out: torch.Tensor, dout: torch.Tensor
                              ) -> torch.Tensor:
    """D = rowsum(dO * O) (BH, Sq) f32 of the forward's output and its
    gradient (both (BH, Sq, hd), one dtype, contiguous)."""
    global pre_launches
    for arg, t in (("out", out), ("dout", dout)):
        check_kernel_tensor(t, PRE_NAME, arg, out)
    require(out.dim() == 3 and dout.shape == out.shape
            and dout.dtype == out.dtype and out.dtype in DTYPE_CODES,
            PRE_NAME, "out and dout must be (BH, Sq, hd) of one dtype")
    BH, Sq, hd = out.shape
    delta = torch.empty((BH, Sq), dtype=torch.float32, device=out.device)
    if skip_launch(out, PRE_NAME, lambda: costs.flash_bwd_preprocess(
            BH, Sq, hd, out.dtype)):
        return delta
    rc = build.library().repro_flash_bwd_preprocess(
        out.data_ptr(), dout.data_ptr(), delta.data_ptr(), BH * Sq, hd,
        DTYPE_CODES[out.dtype], stream_of(out))
    build.check(rc, PRE_NAME)
    pre_launches += 1
    return delta


def _check_bwd(name, q, k, v, dout, lse, delta):
    _check_qkv(q, k, v, name)
    check_kernel_tensor(dout, name, "dout", q)
    require(dout.shape == q.shape and dout.dtype == q.dtype, name,
            "dout must have q's shape and dtype")
    for arg, t in (("lse", lse), ("delta", delta)):
        check_kernel_tensor(t, name, arg, q)
        require(t.shape == q.shape[:2] and t.dtype == torch.float32, name,
                f"{arg} must be (BH, Sq) float32")


def flash_bwd_dkdv_cuda(q, k, v, dout, lse, delta, *, causal: bool = True,
                        window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of k's shape and dtype: a block a key tile (64 keys on the
    tensor cores, 32 on the SIMT path), summing over its KV head's query
    heads and query tiles in order."""
    global dkdv_launches
    _check_bwd(DKDV_NAME, q, k, v, dout, lse, delta)
    require(window >= 0, DKDV_NAME, "window must be >= 0")
    BH, Sq, hd = q.shape
    BHkv, Sk, _ = k.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if skip_launch(q, DKDV_NAME, lambda: costs.flash_bwd_dkdv(
            BH, BHkv, Sq, Sk, hd, q.dtype, causal, window)):
        return dk, dv
    rc = build.library().repro_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        BHkv, Sq, Sk, hd, int(causal), window, DTYPE_CODES[q.dtype],
        stream_of(q))
    build.check(rc, DKDV_NAME)
    dkdv_launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """dq of q's shape and dtype: a block a query tile (64 rows on the
    tensor cores, 32 on the SIMT path), summing over the key tiles in
    order."""
    global dq_launches
    _check_bwd(DQ_NAME, q, k, v, dout, lse, delta)
    require(window >= 0, DQ_NAME, "window must be >= 0")
    BH, Sq, hd = q.shape
    BHkv, Sk, _ = k.shape
    dq = torch.empty_like(q)
    if skip_launch(q, DQ_NAME, lambda: costs.flash_bwd_dq(
            BH, BHkv, Sq, Sk, hd, q.dtype, causal, window)):
        return dq
    rc = build.library().repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, BHkv, Sq, Sk,
        hd, int(causal), window, DTYPE_CODES[q.dtype], stream_of(q))
    build.check(rc, DQ_NAME)
    dq_launches += 1
    return dq
