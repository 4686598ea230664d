"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; skipped where there is none). Needs no JAX:

    pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels with nvcc into build/repro_torch/.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.fused_rmsnorm import (  # noqa: E402
    fused_rmsnorm_cuda, fused_rmsnorm_plain)

# test_kernels.py:23
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build with nvcc there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(card, dtype):
    """Kernel against plain version on the card, over ragged shapes, GQA
    and windows; f32 2e-5 / bf16 2e-2 as test_kernels.py."""
    g = torch.Generator(device=card).manual_seed(0)
    dt = TDT[dtype]

    def r(*shape):
        return torch.randn(shape, generator=g, device=card).to(dt)

    for n, d in ((1, 4096), (77, 4096), (100, 128), (3, 72)):
        x, w = r(n, d), torch.randn(d, generator=g, device=card) * 0.1
        torch.testing.assert_close(fused_rmsnorm_cuda(x, w),
                                   fused_rmsnorm_plain(x, w), **TOL[dtype])
    for bh, bh_kv, sq, sk, hd, causal, window in (
            (4, 4, 96, 96, 64, True, 0), (2, 2, 64, 192, 64, False, 0),
            (6, 2, 77, 77, 128, True, 0), (2, 2, 128, 128, 64, True, 16),
            (3, 3, 1, 1, 16, True, 0), (2, 2, 200, 200, 32, True, 64)):
        q, k, v = r(bh, sq, hd), r(bh_kv, sk, hd), r(bh_kv, sk, hd)
        torch.testing.assert_close(
            flash_attention_cuda(q, k, v, causal=causal, window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window),
            **TOL[dtype])
    for bh, bh_kv, s, hd, window in ((4, 4, 512, 64, 0), (6, 3, 96, 128, 0),
                                     (4, 4, 128, 16, 16)):
        q, k, v = r(bh, 1, hd), r(bh_kv, s, hd), r(bh_kv, s, hd)
        lengths = torch.tensor([s, max(s // 2, 1), 7, 1, 50, 3][:bh],
                               dtype=torch.int32, device=card)
        torch.testing.assert_close(
            decode_attention_cuda(q, k, v, lengths, window=window),
            decode_attention_plain(q, k, v, lengths, window=window),
            **TOL[dtype])
    torch.cuda.synchronize()
