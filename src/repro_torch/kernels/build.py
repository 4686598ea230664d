"""Builds the port's CUDA kernels into one shared library at first use.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (with ``SOURCE_FLAGS`` added for the
sources that name them); the objects are linked into one
library with a plain C interface, loaded with :mod:`ctypes`. The library
is named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. It goes to ``build/repro_torch/``
at the root of the checkout (git-ignored). ``nvcc`` is taken from
``PATH``, else from ``$CUDA_HOME/bin``, else from ``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_rmsnorm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "decode_attention.cu", "ssm_scan.cu", "ssm_scan_bwd.cu",
           "rwkv6_scan.cu", "rwkv6_scan_bwd.cu", "mc_cell.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")
# Flags of one source only: the Monte-Carlo cell is held bit for bit to
# the scalar engine, so no product and add may be contracted into an FMA.
# Its f64 code now holds no multiply, so what keeps a DFMA out is
# chip_smoke.py's SASS check; should this source need more flags of its
# own, put the rounding in the source (__dadd_rn) instead.
SOURCE_FLAGS = {"mc_cell.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types; every function returns a cudaError_t as int
SIGNATURES = {
    # x, w, out, n, d, eps, dtype, stream
    "repro_fused_rmsnorm": (_P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    # x, w, dy, dx, dw, partial, n, d, eps, dtype, stream
    "repro_fused_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I,
                                ctypes.c_float, _I, _P),
    # q, k, v, out, lse (or null), bh, bh_kv, sq, sk, hd, causal, window,
    # softcap, dtype, stream
    "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, ctypes.c_float, _I, _P),
    # out, dout, delta, rows, hd, dtype, stream
    "repro_flash_bwd_preprocess": (_P, _P, _P, _I, _I, _I, _P),
    # q, k, v, dout, lse, delta, dk, dv, bh, bh_kv, sq, sk, hd, causal,
    # window, dtype, stream
    "repro_flash_bwd_dkdv": (_P,) * 8 + (_I,) * 8 + (_P,),
    # q, k, v, dout, lse, delta, dq, bh, bh_kv, sq, sk, hd, causal, window,
    # dtype, stream
    "repro_flash_bwd_dq": (_P,) * 7 + (_I,) * 8 + (_P,),
    # q, k, v, lengths, partials, out, bh, bh_kv, S, hd, span, window,
    # softcap, dtype, stream
    "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, ctypes.c_float, _I, _P),
    # xbar, B, C, cumlog, y, h, bh, bh_bc, S, hd, ds, chunk, dtype, stream
    "repro_ssm_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P),
    # xbar, B, C, cumlog, dy, dh, dxbar, dB, dC, dcumlog, states, partial,
    # bh, bh_bc, S, hd, ds, chunk, dtype, stream
    "repro_ssm_scan_bwd": (_P,) * 12 + (_I,) * 7 + (_P,),
    # r, k, v, w, u, o, state, bh, n_u, S, hd, dtype, stream
    "repro_rwkv6_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # r, k, v, w, u, do, dstate, dr, dk, dv, dw, du, ckpt, dv_part,
    # du_part, bh, n_u, S, hd, dtype, stream
    "repro_rwkv6_scan_bwd": (_P,) * 15 + (_I,) * 5 + (_P,),
    # arrival, n_tasks, n_fifo, limit, max_events, rem, vr, rq,
    # completion, first_run, cpu_time, preemptions, ctx_switches,
    # migrations, ok, n_events, slices, K, B, C, N, ctx, stream
    "repro_mc_cell": (_P,) * 17 + (_I,) * 4 + (ctypes.c_double, _P),
}

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    candidates = [shutil.which("nvcc"),
                  os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "at first use and need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it already exists; returns its
    path. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [cc, *COMPILE_FLAGS, *SOURCE_FLAGS.get(s, ()), "-c", str(CSRC / s),
             "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [cc, *ARCH_FLAGS, "-shared", "-o", str(Path(tmp) / out.name),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("\n".join(logs) + link.stdout)
        os.replace(Path(tmp) / out.name, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a launch the runtime refused (the C side returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
