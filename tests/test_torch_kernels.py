"""The port's kernels (repro_torch.kernels).

Each plain PyTorch version is held against the JAX oracle
(repro.kernels.ref) and against the Pallas kernel it replaces, run in
interpret mode on the CPU, over the shape sweep of test_kernels.py. The
CUDA kernels themselves are held against the plain versions on the card
in test_torch_cuda.py.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import (decode_attention as pallas_decode,  # noqa: E402
                           flash_attention as pallas_flash,
                           fused_rmsnorm as pallas_rmsnorm, ref)
from repro_torch.kernels import build, ops, plain  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.fused_rmsnorm import (  # noqa: E402
    fused_rmsnorm_cuda, fused_rmsnorm_plain)

# test_kernels.py:23
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(rng, shape, dtype, scale=1.0):
    """The same values in both frameworks: f32 numpy, rounded once."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (torch.from_numpy(a).to(TDT[dtype]),
            jnp.asarray(a).astype(JDT[dtype]))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,hd,qb,kb", [
    (2, 128, 128, 64, 64, 64),
    (1, 96, 96, 64, 64, 64),      # non-multiple of block
    (3, 256, 256, 128, 128, 64),
    (2, 64, 192, 64, 64, 64),     # cross-attn shaped (sq != sk)
])
def test_flash_plain_matches_ref_and_pallas(dtype, bh, sq, sk, hd, qb, kb):
    rng = np.random.default_rng(sq * 7 + sk)
    (tq, jq), (tk, jk), (tv, jv) = (rand(rng, (bh, s, hd), dtype)
                                    for s in (sq, sk, sk))
    causal = sq == sk
    out = f32(flash_attention_plain(tq, tk, tv, causal=causal))
    exp = f32(ref.flash_attention_ref(jq, jk, jv, causal=causal))
    pal = f32(pallas_flash(jq, jk, jv, causal=causal, q_block=qb,
                           k_block=kb, interpret=True))
    np.testing.assert_allclose(out, exp, **TOL[dtype])
    np.testing.assert_allclose(out, pal, **TOL[dtype])


@pytest.mark.parametrize("window", [16, 64])
def test_flash_plain_window(window):
    rng = np.random.default_rng(window)
    (tq, jq), (tk, jk), (tv, jv) = (rand(rng, (2, 128, 64), "float32")
                                    for _ in range(3))
    out = f32(flash_attention_plain(tq, tk, tv, window=window))
    exp = f32(ref.flash_attention_ref(jq, jk, jv, window=window))
    pal = f32(pallas_flash(jq, jk, jv, window=window, q_block=32,
                           k_block=32, interpret=True))
    np.testing.assert_allclose(out, exp, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pal, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,kb", [(128, 64), (96, 64), (512, 128)])
def test_decode_plain_matches_ref_and_pallas(dtype, s, kb):
    rng = np.random.default_rng(s)
    bh, hd = 4, 64
    tq, jq = rand(rng, (bh, 1, hd), dtype)
    tk, jk = rand(rng, (bh, s, hd), dtype)
    tv, jv = rand(rng, (bh, s, hd), dtype)
    lengths = np.array([s, max(s // 2, 1), 7, 1], np.int32)
    out = f32(decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths)))
    exp = f32(ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths)))
    pal = f32(pallas_decode(jq, jk, jv, jnp.asarray(lengths), k_block=kb,
                            interpret=True))
    np.testing.assert_allclose(out, exp, **TOL[dtype])
    np.testing.assert_allclose(out, pal, **TOL[dtype])


def test_decode_plain_window():
    rng = np.random.default_rng(5)
    tq, jq = rand(rng, (4, 1, 64), "float32")
    tk, jk = rand(rng, (4, 128, 64), "float32")
    tv, jv = rand(rng, (4, 128, 64), "float32")
    lengths = np.array([128, 64, 7, 1], np.int32)
    out = f32(decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths),
                                     window=16))
    exp = f32(ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths),
                                       window=16))
    pal = f32(pallas_decode(jq, jk, jv, jnp.asarray(lengths), k_block=32,
                            window=16, interpret=True))
    np.testing.assert_allclose(out, exp, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pal, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,rows", [(100, 128, 32), (256, 512, 256)])
def test_rmsnorm_plain_matches_ref_and_pallas(dtype, n, d, rows):
    rng = np.random.default_rng(n + d)
    tx, jx = rand(rng, (n, d), dtype)
    tw, jw = rand(rng, (d,), "float32", 0.1)
    out = f32(fused_rmsnorm_plain(tx, tw))
    exp = f32(ref.fused_rmsnorm_ref(jx, jw))
    pal = f32(pallas_rmsnorm(jx, jw, rows=rows, interpret=True))
    np.testing.assert_allclose(out, exp, **TOL[dtype])
    np.testing.assert_allclose(out, pal, **TOL[dtype])


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_plain_gqa_rows_read_kv_row_bh_div_group(kernel):
    """q row bh reads k/v row bh // G: the same as repeating k/v G times."""
    rng = np.random.default_rng(11)
    G, bh_kv, s, hd = 3, 2, 40, 32
    k = torch.from_numpy(rng.standard_normal((bh_kv, s, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((bh_kv, s, hd), np.float32))
    kr, vr = k.repeat_interleave(G, 0), v.repeat_interleave(G, 0)
    if kernel == "flash":
        q = torch.from_numpy(rng.standard_normal((G * bh_kv, s, hd),
                                                 np.float32))
        out = flash_attention_plain(q, k, v)
        exp = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(kr),
                                      jnp.asarray(vr))
    else:
        q = torch.from_numpy(rng.standard_normal((G * bh_kv, 1, hd),
                                                 np.float32))
        lengths = torch.tensor([40, 1, 9, 33, 17, 2], dtype=torch.int32)
        out = decode_attention_plain(q, k, v, lengths)
        exp = ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kr),
                                       jnp.asarray(vr),
                                       jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(f32(out), f32(exp), rtol=2e-5, atol=2e-5)


def test_ops_dispatch_cpu_to_plain_without_counting():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 64), np.float32))
    w = torch.zeros(64)
    q = torch.from_numpy(rng.standard_normal((2, 7, 16), np.float32))
    lengths = torch.tensor([7, 3], dtype=torch.int32)
    ops.reset_launch_counts()
    assert torch.equal(ops.fused_rmsnorm(x, w), plain.fused_rmsnorm(x, w))
    assert torch.equal(ops.flash_attention(q, q, q),
                       plain.flash_attention(q, q, q))
    assert torch.equal(ops.decode_attention(q[:, :1], q, q, lengths),
                       plain.decode_attention(q[:, :1], q, q, lengths))
    assert ops.launch_counts() == {"fused_rmsnorm": 0, "flash_attention": 0,
                                   "decode_attention": 0, "ssm_scan": 0,
                                   "rwkv6_scan": 0, "mc_cell": 0,
                                   "fused_rmsnorm_bwd": 0,
                                   "flash_bwd_preprocess": 0,
                                   "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                                   "ssm_scan_bwd": 0, "rwkv6_scan_bwd": 0}


def test_ops_raise_on_a_device_without_kernel():
    """Neither the card, nor the meta device (the dry run's route through
    the kernel wrappers), nor the CPU: no kernel, and the call raises."""
    x = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops.fused_rmsnorm(x, torch.zeros(64))


@pytest.mark.parametrize("name", ["fused_rmsnorm", "flash_attention",
                                  "decode_attention"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """The kernel wrappers check their inputs before any build or launch:
    a CPU tensor is refused, never passed on as a pointer."""
    q = torch.zeros((2, 1, 64))
    calls = {
        "fused_rmsnorm": lambda: fused_rmsnorm_cuda(q[:, 0], torch.zeros(64)),
        "flash_attention": lambda: flash_attention_cuda(q, q, q),
        "decode_attention": lambda: decode_attention_cuda(
            q, q, q, torch.ones(2, dtype=torch.int32)),
    }
    before = ops.launch_counts()[name]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        calls[name]()
    assert ops.launch_counts()[name] == before


def test_build_goes_to_the_ignored_build_dir():
    root = Path(__file__).resolve().parents[1]
    path = build.library_path()
    assert path.parent == root / "build" / "repro_torch"
    assert "build/" in (root / ".gitignore").read_text().split()
    for name in build.SOURCES + build.HEADERS:
        assert (build.CSRC / name).is_file()
    assert "arch=compute_90a,code=sm_90a" in build.ARCH_FLAGS
