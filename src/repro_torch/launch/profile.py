"""Where the time of the serving path goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile
  PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.profile --trace out.json

Builds ``--arch`` (default deepseek-7b) at full width with random bf16
weights (seed 0), then traces one prefill of a 513-token prompt and 4
decode steps over a 1024-slot cache with ``torch.profiler``. For each
phase it prints the host-clock time (ending in a device synchronise),
the device's busy time (the sum of the kernels' device times; one
stream, so they do not overlap), the idle share ``1 - busy / wall``, and
the device time by operation: the port's five kernels, matrix products,
and everything else.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS, get_config
from ..models import LM
from ..params import init_params

PROMPT, STEPS, MAX_LEN, SEED, TOP = 513, 4, 1024, 0, 8
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


def device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def traced(fn, trace_path=None):
    """Run ``fn`` under the profiler; returns (wall ms, {group: device
    ms}, [(kernel, device ms, calls)])."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    by_group: dict[str, float] = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = device_us(evt) / 1e3
        if ms <= 0:
            continue
        by_group[group_of(evt.key)] += ms
        kernels.append((evt.key, ms, evt.count))
    kernels.sort(key=lambda k: -k[1])
    return wall_ms, dict(by_group), kernels


def report(name: str, wall_ms: float, by_group: dict, kernels: list
           ) -> None:
    busy = sum(by_group.values())
    if busy <= 0:
        raise SystemExit(f"profile: the trace of {name} holds no device "
                         "time; torch.profiler did not trace the card")
    print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in sorted(by_group.items(), key=lambda g: -g[1]):
        print(f"  {group:17s} {ms:10.3f} ms  {ms / busy:6.1%} of busy")
    for key, ms, calls in kernels[:TOP]:
        print(f"    {ms:9.3f} ms {calls:6d} calls  {key[:110]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--trace", default=None,
                    help="write the decode steps' chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    lm = LM.from_params(cfg, init_params(cfg, seed=SEED, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, PROMPT), generator=gen,
                         device="cuda")
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill(toks, MAX_LEN)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)
        for i in range(STEPS):
            pos = torch.tensor([PROMPT + i], device="cuda")
            logits, _ = lm.decode_step(tok, state["cache"], pos)
            tok = logits[:, -1].argmax(-1)

    with torch.inference_mode():
        prefill()                                   # warm-up
        decode()
        report(f"{cfg.name} prefill {PROMPT} tokens", *traced(prefill))
        wall, groups, kernels = traced(decode, args.trace)
        report(f"{cfg.name} decode {STEPS} steps", wall, groups, kernels)
        print(f"decode per step: wall {wall / STEPS:.3f} ms, device "
              f"busy {sum(groups.values()) / STEPS:.3f} ms")


if __name__ == "__main__":
    main()
