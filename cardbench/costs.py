"""The yardstick: a frozen copy of the port's cost and roofline arithmetic.

Copied from ``repro_torch/kernels/costs.py`` (``bound``, ``peak_rate``,
``decode``), the peaks of ``repro_torch/launch/mesh.py`` and the kernel
grouping of ``repro_torch/launch/profile.py`` (``GROUPS``,
``group_of``), so that a change to the program cannot move what its
kernels are measured against. ``tests/test_cardbench_costs.py`` holds
the copy equal to the program's formulas at the cells' shapes. Adds the
whole decode step's bytes and operations of a uniform (attention + MLP
or MoE) stack.

A cost is ``(bytes, flops, flops_per_s)``: each input read once and each
output written once, the operations the call's shapes need (an FMA is
2), and the card's peak for their type.
"""
from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense rates)
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12          # f32 on the CUDA cores
HBM_BW = 3.35e12                # bytes/s of HBM3

ITEMSIZE = {"bfloat16": 2, "float32": 4}

GROUPS = (("fused_rmsnorm", ("rmsnorm_kernel", "rmsnorm_loop_kernel")),
          ("flash_attention", ("flash_tc_kernel", "flash_f32_kernel")),
          ("decode_attention", ("decode_split_kernel",
                                "decode_combine_kernel")),
          ("ssm_scan", ("ssm_tc_kernel", "ssm_scan_kernel")),
          ("rwkv6_scan", ("rwkv6_chunk_kernel",)),
          ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitK")))


def group_of(kernel_name: str) -> str:
    for group, keys in GROUPS:
        if any(k in kernel_name for k in keys):
            return group
    return "other"


def bound(nbytes: float, flops: float, flops_per_s: float
          ) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate and the flops over their peak."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_rate(dtype: str) -> float:
    return PEAK_FLOPS_BF16 if dtype == "bfloat16" else PEAK_FLOPS_F32


def decode(bh: int, bh_kv: int, hd: int, dtype: str, query_keys: int,
           cache_keys: int):
    """``cache_keys`` keys and values read (once a KV head), q read and o
    written, lengths read; 4 hd flops a key of each query head."""
    size = ITEMSIZE[dtype]
    return (2 * cache_keys * hd * size + 2 * bh * hd * size + 4 * bh,
            4 * hd * query_keys, peak_rate(dtype))


# -- whole steps of a uniform stack (the benchmark's own) ----------------------

def layer_matmul_elems(m: dict, active: bool) -> int:
    """Matmul weight elements one token multiplies in one layer: q, k, v,
    o, and the MLP's three, or with experts the router and the three of
    each expert it reaches (``active``: top_k of them, else all)."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    if m["n_experts"]:
        n = m["top_k"] if active else m["n_experts"]
        return attn + d * m["n_experts"] + n * 3 * d * m["d_ff"]
    return attn + 3 * d * m["d_ff"]


def decode_step(m: dict, live: int):
    """(bytes, flops) of one decode step of one row at ``live`` cached
    positions (the new one included): the weights a token needs once (bf16
    matmul weights, routed experts only; the f32 norms; the f32 head and
    the embedding row), the K/V cache read at the live length and the new
    key and value written; 2 flops a weight element, 4 hd a live key of
    each query head, 2 d V for the head."""
    L, d, V, hd = m["n_layers"], m["d_model"], m["vocab"], m["head_dim"]
    w = ITEMSIZE[m["dtype"]]
    elems = layer_matmul_elems(m, active=True)
    kv = 2 * m["n_kv_heads"] * hd * w
    nbytes = (L * (elems * w + 2 * d * 4 + kv * (live + 1))
              + d * 4 + d * V * 4 + d * 4)
    flops = L * (2 * elems + 4 * hd * m["n_heads"] * live) + 2 * d * V
    return nbytes, flops
