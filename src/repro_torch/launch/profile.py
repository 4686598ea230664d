"""Where the time of the serving path goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile
  PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.profile --trace out.json
  PYTHONPATH=src python -m repro_torch.launch.profile --arch gemma3-12b \\
      --prompt 1500
  PYTHONPATH=src python -m repro_torch.launch.profile --arch gemma3-27b \\
      --prompt 1500

Builds ``--arch`` (default deepseek-7b) at full width with random bf16
weights (seed 0), then traces one prefill of a ``--prompt``-token prompt
(513) and 4 decode steps over a cache of 1024 slots (2048 past 1020
tokens) with ``torch.profiler``: eager
``LM.decode_step`` calls, then the engine's graphed steps (a replay of
the slot's CUDA graph and the greedy token read on the host, as
``ServingEngine`` decodes). For each phase it prints the host-clock time
(ending in a device synchronise), the device's busy time (the sum of the
kernels' device times; one stream, so they overlap only where a
programmatic dependent launch starts early), the idle share
``1 - busy / wall``, and the device time and launches by operation: the
port's five kernels, matrix products, and everything else. Tracing
costs the host time, so each decode phase is also timed untraced and
its idle share given against that wall too; the graphed steps are also
timed between CUDA events. Last it counts the nodes and dependency edges
of a captured decode step by type (libcuda's graph API): whether the
programmatic dependent launches of the norm and the decode combine kept
programmatic edges in the graph.

For a model with experts it also traces the MoE layers piece by piece,
at the prefill's and at a decode step's shape, over every MoE layer on
the hidden states of a random prompt: the norm, the router (product,
softmax, top K), the dispatch (sort by expert, slots, buffer), the
expert products and the combine, each its device time and launches.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import time
from collections import Counter, defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS, get_config
from ..models import LM, layers
from ..params import init_params
from ..serving.graphs import SlotDecoder, capture

PROMPT, STEPS, SEED, TOP = 513, 4, 0, 8
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
    """Run ``fn`` under the profiler; returns (wall ms, {group: (device
    ms, launches)}, [(kernel, device ms, calls)])."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    by_group: dict[str, list] = defaultdict(lambda: [0.0, 0])
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = device_us(evt) / 1e3
        if ms <= 0:
            continue
        by_group[group_of(evt.key)][0] += ms
        by_group[group_of(evt.key)][1] += evt.count
        kernels.append((evt.key, ms, evt.count))
    kernels.sort(key=lambda k: -k[1])
    return wall_ms, dict(by_group), kernels


def unprofiled_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn`` outside the
    profiler, each ending in a device synchronise: the wall without the
    tracing's own host cost."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def busy_ms(by_group: dict) -> float:
    return sum(ms for ms, _ in by_group.values())


def report(name: str, wall_ms: float, by_group: dict, kernels: list
           ) -> None:
    busy = busy_ms(by_group)
    if busy <= 0:
        raise SystemExit(f"profile: the trace of {name} holds no device "
                         "time; torch.profiler did not trace the card")
    print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, (ms, n) in sorted(by_group.items(), key=lambda g: -g[1][0]):
        print(f"  {group:17s} {ms:10.3f} ms  {ms / busy:6.1%} of busy, "
              f"{n:6d} launches, {ms / n * 1e3:8.2f} us a launch")
    for key, ms, calls in kernels[:TOP]:
        print(f"    {ms:9.3f} ms {calls:6d} calls  {key[:110]}")


def graph_edges(fn) -> str:
    """Captures ``fn`` once more, keeping the graph, and counts its nodes
    by type and its dependency edges by type and outgoing port with the
    libcuda's cuGraphGetNodes / cuGraphNodeGetType / cuGraphGetEdges_v2.
    A programmatic dependent launch that capture kept is an edge of type
    1 (programmatic); one turned into a full dependency is of type 0."""
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        return f"not measured (this torch keeps no captured graph: {e})"
    capture(fn, graph=graph)
    cu = ctypes.CDLL("libcuda.so.1")
    if not hasattr(cu, "cuGraphGetEdges_v2"):
        return "not measured (this libcuda has no cuGraphGetEdges_v2)"
    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)

    def call(fn, *args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__}: CUresult {rc}")

    call(cu.cuGraphGetNodes, h, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes, h, nodes, ctypes.byref(n))
    kinds, kind = Counter(), ctypes.c_int(0)
    for node in nodes:
        call(cu.cuGraphNodeGetType, ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[{0: "kernel", 1: "memcpy", 2: "memset"}.get(kind.value,
                                                          str(kind.value))] += 1
    call(cu.cuGraphGetEdges_v2, h, None, None, None, ctypes.byref(n))
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (ctypes.c_uint8 * (8 * n.value))()      # CUgraphEdgeData
    call(cu.cuGraphGetEdges_v2, h, src, dst, data, ctypes.byref(n))
    edges = Counter((data[8 * i + 2], data[8 * i]) for i in range(n.value))
    return (f"{len(nodes)} nodes {dict(kinds)}; {n.value} edges by (type, "
            f"outgoing port): {dict(sorted(edges.items()))} (type 1 = "
            f"programmatic)")


def moe_pieces(lm: LM, S: int) -> None:
    """Device time of each piece of the MoE layers on (1, S) tokens:
    every piece runs over all MoE layers in its own trace, on inputs the
    pieces before it computed."""
    cfg = lm.cfg
    mods = [layer.moe for layer in lm.layers if hasattr(layer, "moe")]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device="cuda") \
        .to(lm.dtype)
    C = layers.capacity(cfg, S)
    st = [{} for _ in mods]

    def norm():
        for p, s in zip(mods, st):
            s["h"] = layers.rmsnorm(x, p.norm, cfg.norm_eps,
                                    kernels=lm.kernels)

    def route():
        for p, s in zip(mods, st):
            _, s["eids"], s["gates"] = layers.route(p, s["h"], cfg)

    def dispatch():
        for s in st:
            s["buf"], order, flat_idx = layers.dispatch(
                s["h"], s["eids"], cfg.n_experts, C)
            s["slots"] = layers.slots_of(order, flat_idx)

    def experts():
        for p, s in zip(mods, st):
            s["yexp"] = layers.experts(p, s["buf"], cfg)

    def combine():
        for s in st:
            layers.combine(s["yexp"], s["slots"], s["gates"])

    pieces = (("norm", norm), ("router", route), ("dispatch", dispatch),
              ("expert products", experts), ("combine", combine))
    for _, fn in pieces:                         # warm-up, and the inputs
        fn()
    rows = [(name, *traced(fn)) for name, fn in pieces]
    total = sum(busy_ms(groups) for _, _, groups, _ in rows)
    print(f"{cfg.name} MoE layers by piece, S {S} (capacity {C} an "
          f"expert), {len(mods)} layers: device busy {total:.3f} ms")
    for name, _, groups, _ in rows:
        ms = busy_ms(groups)
        n = sum(k for _, k in groups.values())
        kinds = ", ".join(f"{g} {g_ms:.3f}" for g, (g_ms, _) in
                          sorted(groups.items(), key=lambda g: -g[1][0]))
        print(f"  {name:15s} {ms:9.3f} ms {ms / total:6.1%}, {n:5d} "
              f"launches ({kinds})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--trace", default=None,
                    help="write the decode steps' chrome trace here")
    ap.add_argument("--prompt", type=int, default=PROMPT)
    args = ap.parse_args(argv)
    S = args.prompt
    max_len = 1024 * -(-(S + STEPS) // 1024)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    lm = LM.from_params(cfg, init_params(cfg, seed=SEED, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                         device="cuda")
    dec = SlotDecoder(lm, 1, max_len)
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill(toks, max_len)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)
        for i in range(STEPS):
            pos = torch.tensor([S + i], device="cuda")
            logits, _ = lm.decode_step(tok, state["cache"], pos)
            tok = logits[:, -1].argmax(-1)

    def decode_graph():
        tok = state["graph_tok"]
        for i in range(STEPS):
            tok = int(dec.step(0, tok, S + i)[0, -1].argmax())

    with torch.inference_mode():
        prefill()                                   # warm-up
        decode()
        dec.prefill(0, toks)
        state["graph_tok"] = int(state["logits"][0, -1].argmax())
        decode_graph()
        report(f"{cfg.name} prefill {S} tokens", *traced(prefill))
        for name, fn, trace in (("decode", decode, args.trace),
                                ("graph decode", decode_graph, None)):
            wall, groups, kernels = traced(fn, trace)
            report(f"{cfg.name} {name} {STEPS} steps", wall, groups, kernels)
            busy, plain_wall = busy_ms(groups), unprofiled_ms(fn)
            print(f"{name} per step: wall {wall / STEPS:.3f} ms traced, "
                  f"{plain_wall / STEPS:.3f} ms untraced; device busy "
                  f"{busy / STEPS:.3f} ms; idle share "
                  f"{max(0.0, 1 - busy / wall):.3f} traced, "
                  f"{max(0.0, 1 - busy / plain_wall):.3f} against the "
                  f"untraced wall")
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(STEPS):
            dec.graphs[0].replay()
        b.record()
        b.synchronize()
        print(f"graph decode: {STEPS} replays back to back "
              f"{a.elapsed_time(b) / STEPS:.3f} ms a step between CUDA "
              "events")
        print(f"decode graph: {graph_edges(lambda: dec.eager_step(0))}")
        if cfg.n_experts:
            for n in (S, 1):
                moe_pieces(lm, n)


if __name__ == "__main__":
    main()
