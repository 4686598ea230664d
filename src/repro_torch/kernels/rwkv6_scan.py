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
emulated in ``tests/test_torch_rwkv_design.py``).
"""
from __future__ import annotations

import torch

from . import build
from .common import (DTYPE_CODES, SCAN_HEAD_DIMS, check_cuda_tensor,
                     refuse_grad, require, stream_of)

NAME = "rwkv6_scan"
CHUNK = 16          # steps a chunk in csrc/rwkv6_scan.cu (kT)
launches = 0


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


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    refuse_grad(NAME, r, k, v, w, u)
    for arg, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        check_cuda_tensor(t, NAME, arg)
    require(r.dtype in DTYPE_CODES, NAME, f"dtype {r.dtype} not supported")
    require(all(t.dtype == r.dtype for t in (k, v, w)), NAME,
            "r, k, v and w must share a dtype")
    require(u.dtype == torch.float32, NAME, "u must be float32")
    require(r.dim() == 3 and all(t.shape == r.shape for t in (k, v, w)),
            NAME, "r, k, v and w must be (BH, S, hd) of one shape")
    BH, S, hd = r.shape
    require(hd in SCAN_HEAD_DIMS, NAME,
            f"head dim must be one of {SCAN_HEAD_DIMS}")
    require(u.dim() == 2 and u.shape[1] == hd and u.shape[0] >= 1
            and BH % u.shape[0] == 0, NAME,
            f"u must be (NU, {hd}) with BH={BH} a multiple of NU")
    require(S >= 1 and BH <= 2 ** 31 - 1, NAME,
            f"unsupported sizes BH={BH} S={S}")
    require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w, u)), NAME,
            "r, k, v, w and u must be 16-byte aligned")   # 16-byte copies
    o = torch.empty_like(r)
    state = torch.empty((BH, hd, hd), dtype=torch.float32, device=r.device)
    rc = build.library().repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        o.data_ptr(), state.data_ptr(), BH, u.shape[0], S, hd,
        DTYPE_CODES[r.dtype], stream_of(r))
    build.check(rc, NAME)
    launches += 1
    return o, state
