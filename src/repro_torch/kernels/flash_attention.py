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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .common import (DTYPE_CODES, HEAD_DIMS, check_cuda_tensor, require,
                     stream_of)

NAME = "flash_attention"
NEG_INF = -1e30
launches = 0


def softcap_scores(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """``_softcap`` of the JAX model: ``c * tanh(s / c)`` for a cap c > 0,
    s unchanged at 0."""
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    group = BH // k.shape[0]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = softcap_scores(torch.matmul(q.float(), kf.transpose(1, 2))
                       / math.sqrt(hd), softcap)
    q_idx = torch.arange(Sq, device=q.device)[:, None]
    k_idx = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if window > 0:
        mask &= k_idx > q_idx - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out``, if given, is a contiguous tensor of q's shape, dtype and
    device that the kernel writes in place (and returns); by default a
    new one."""
    global launches
    for arg, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, NAME, arg)
        require(t.dim() == 3, NAME, f"{arg} must be 3-D, got {tuple(t.shape)}")
        require(t.data_ptr() % 16 == 0, NAME,      # 16-byte async copies
                f"{arg} must be 16-byte aligned")
    require(q.dtype in DTYPE_CODES, NAME, f"dtype {q.dtype} not supported")
    require(k.dtype == q.dtype and v.dtype == q.dtype, NAME,
            "q, k and v must share a dtype")
    BH, Sq, hd = q.shape
    BHkv, Sk, hdk = k.shape
    require(v.shape == k.shape, NAME, "k and v must have one shape")
    require(hdk == hd and hd in HEAD_DIMS, NAME,
            f"head dim must match and be one of {HEAD_DIMS}")
    require(BHkv >= 1 and BH % BHkv == 0, NAME,
            f"BH={BH} must be a multiple of BH_kv={BHkv}")
    require(Sq >= 1 and Sk >= 1 and BH <= 65535 and Sq <= 65535 * 64, NAME,
            f"unsupported sizes BH={BH} Sq={Sq} Sk={Sk}")
    require(window >= 0, NAME, "window must be >= 0")
    require(softcap >= 0, NAME, "softcap must be >= 0")
    if out is None:
        out = torch.empty_like(q)
    else:
        check_cuda_tensor(out, NAME, "out")
        require(out.shape == q.shape and out.dtype == q.dtype
                and out.data_ptr() % 16 == 0, NAME,
                "out must have q's shape and dtype and be 16-byte aligned")
    rc = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, BHkv,
        Sq, Sk, hd, int(causal), window, softcap, DTYPE_CODES[q.dtype],
        stream_of(q))
    build.check(rc, NAME)
    launches += 1
    return out
