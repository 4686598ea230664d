"""Per-op feature extraction for the learned cost model (own copy of
``repro.costmodel.features``, the kernel rows taken from the port's own
kernels).

Two sources, one row schema:

* :func:`kernel_features` — the port's hand-written kernels
  (``kernels.ops``): each case runs once on meta tensors, through the
  same wrapper the card's call takes, and the bytes and flops its
  wrapper records (``kernels.costs``, the formulas ``chip_smoke.py``'s
  bounds use) are the row. The JAX package reads them from compiled HLO
  instead, so the two packages' kernel rows differ by design.
* :func:`llm_chunk_features` — the ``serving.llm`` chunk shapes,
  derived analytically (2·params FLOPs per token, weights + KV bytes
  per step).

Row schema (``FEATURE_KEYS``): ``op`` (label), ``flops``, ``bytes``,
``trips`` (the kernel launches of one call), ``tokens`` (llm rows). The
calibrator fits latency on (1, gflops, mbytes) — scaled so the normal
equations stay well-conditioned in float64.
"""
from __future__ import annotations

from typing import Optional

FEATURE_KEYS = ("op", "flops", "bytes", "trips")

# Feature scaling used everywhere a predictor touches a row: raw FLOP /
# byte counts are ~1e9 / ~1e6 and would wreck the normal equations.
GFLOP = 1e9
MBYTE = 1e6

#: the chunk ``repro.kernels.ops.ssm_scan`` defaults to
SSM_CHUNK = 64


def feature_vector(row: dict) -> tuple:
    """(1.0, gflops, mbytes) — THE predictor input for a feature row."""
    return (1.0, float(row["flops"]) / GFLOP, float(row["bytes"]) / MBYTE)


# -- analytic llm chunk features -------------------------------------------

def llm_chunk_features(cfg, seq_len: int = 4096,
                       prefill_tokens: int = 1024) -> list[dict]:
    """Feature rows for the two ``serving.llm`` chunk kinds.

    Dense-equivalent FLOPs: 2·params per token (the standard inference
    estimate); bytes: one full weight read plus the KV the step
    touches. MoE checkpoints ship every expert but activate
    ``n_active``/``n_experts`` of the MLP share — the analytic model
    follows the same approximation ``approx_param_bytes`` uses.
    """
    from ..serving.llm import BYTES_PER_PARAM, approx_param_bytes
    from ..serving.request import kv_bytes

    param_bytes = approx_param_bytes(cfg)
    params = param_bytes / BYTES_PER_PARAM
    n_exp = max(getattr(cfg, "n_experts", 0), 1)
    top_k = max(getattr(cfg, "top_k", 0), 1) if n_exp > 1 else 1
    active = params * (top_k / n_exp) if n_exp > 1 else params
    rows = [
        {
            "op": "llm_prefill",
            "tokens": prefill_tokens,
            "flops": 2.0 * active * prefill_tokens,
            "bytes": param_bytes + kv_bytes(cfg, prefill_tokens),
            "trips": max(1, prefill_tokens // 512),
        },
        {
            "op": "llm_decode",
            "tokens": 1,
            "flops": 2.0 * active,
            "bytes": param_bytes + kv_bytes(cfg, seq_len),
            "trips": 1,
        },
    ]
    return rows


# -- kernel features -----------------------------------------------------------

def kernel_shapes(small: bool = True) -> tuple[int, int, int, int]:
    """(BH, S, hd, ds) of the kernel cases."""
    return (2, 128, 64, 16) if small else (4, 512, 64, 16)


def _kernel_cases(small: bool = True, device="cpu") -> list[tuple]:
    """(name, builder) pairs; builder() -> (fn, args) on ``device``. The
    inputs are the JAX package's, draw for draw (numpy seeds 0-16, f32),
    its odd ones included: ``ssm_scan`` gets a cumulative log-decay over
    the whole sequence with no reset at the chunk starts, ``rwkv6_scan``
    a negative ``w``."""
    import functools

    import numpy as np
    import torch

    from ..kernels import ops

    BH, S, hd, ds = kernel_shapes(small)

    def _r(shape, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(device)

    def flash():
        q, k, v = _r((BH, S, hd), 0), _r((BH, S, hd), 1), _r((BH, S, hd), 2)
        return ops.flash_attention, (q, k, v)

    def decode():
        q = _r((BH, 1, hd), 3)
        k, v = _r((BH, S, hd), 4), _r((BH, S, hd), 5)
        lengths = torch.full((BH,), S, dtype=torch.int32, device=device)
        return ops.decode_attention, (q, k, v, lengths)

    def ssm():
        xbar = _r((BH, S, hd), 6)
        B, C = _r((BH, S, ds), 7), _r((BH, S, ds), 8)
        cumlog = torch.cumsum(-torch.abs(_r((BH, S), 9)) * 0.01, dim=-1)
        return functools.partial(ops.ssm_scan, chunk=SSM_CHUNK), \
            (xbar, B, C, cumlog)

    def rwkv():
        r, k, v = _r((BH, S, hd), 10), _r((BH, S, hd), 11), _r((BH, S, hd), 12)
        w = -torch.abs(_r((BH, S, hd), 13)) * 0.1
        u = _r((BH, hd), 14)
        return ops.rwkv6_scan, (r, k, v, w, u)

    def rmsnorm():
        x, w = _r((S * BH, 4 * hd), 15), _r((4 * hd,), 16)
        return ops.fused_rmsnorm, (x, w)

    return [("flash_attention", flash), ("decode_attention", decode),
            ("ssm_scan", ssm), ("rwkv6_scan", rwkv),
            ("fused_rmsnorm", rmsnorm)]


def case_features(name: str, fn, args) -> dict:
    """One case's row: ``fn`` run once on meta copies of ``args``, the
    bytes and flops its wrapper records summed, ``trips`` the launches it
    records."""
    import torch

    from ..kernels import costs

    meta = tuple(a.to("meta") for a in args)
    with torch.no_grad(), costs.recording() as calls:
        fn(*meta)
    if not calls:
        raise RuntimeError(f"{name}: the meta call recorded no launch")
    return {"op": name,
            "flops": float(sum(c[2] for c in calls)),
            "bytes": float(sum(c[1] for c in calls)),
            "trips": len(calls)}


def kernel_features(small: bool = True, ops_filter: Optional[list] = None,
                    ) -> list[dict]:
    """FLOP/byte/trip rows of the port's kernels at the cases' shapes, read
    on the meta device: no card and no compiler needed."""
    return [case_features(name, *builder())
            for name, builder in _kernel_cases(small)
            if ops_filter is None or name in ops_filter]
