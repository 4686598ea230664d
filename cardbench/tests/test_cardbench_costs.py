"""The benchmark's frozen copy of the cost arithmetic equals the
program's formulas at the cells' shapes, on this commit of the program."""
from __future__ import annotations

import pytest
import torch

from cardbench import costs
from repro_torch.kernels import costs as program
from repro_torch.launch import mesh, profile

DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (H, KV, hd) of deepseek-7b and granite-moe-3b-a800m
HEADS = ((32, 32, 128), (24, 8, 64))


def test_peaks():
    assert (costs.PEAK_FLOPS_BF16, costs.PEAK_FLOPS_F32, costs.HBM_BW) == (
        mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW)


@pytest.mark.parametrize("H,KV,hd", HEADS)
@pytest.mark.parametrize("S", (16, 1020, 1500, 4095))
@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_decode(H, KV, hd, S, dtype):
    assert costs.decode(H, KV, hd, dtype, H * S, KV * S) == program.decode(
        H, KV, hd, DT[dtype], H * S, KV * S)
    assert costs.bound(*costs.decode(H, KV, hd, dtype, H * S, KV * S)) == \
        program.bound(*program.decode(H, KV, hd, DT[dtype], H * S, KV * S))


def test_kernel_groups():
    assert costs.GROUPS == profile.GROUPS
    for name in ("void decode_split_kernel<bf16>", "nvjet_tst_128x64",
                 "flash_tc_kernel<128>", "rmsnorm_kernel", "elementwise",
                 "sm90_xmma_gemm", "decode_combine_kernel"):
        assert costs.group_of(name) == profile.group_of(name)
