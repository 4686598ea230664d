"""One run of one cell: build the cell's engine, warm it up, serve the
cell's traffic for the window, read the metrics and check the output.

The benchmark finds everything of a cell by its names in
``BENCHMARK.json``: the configuration ``configs/<config>.json``, the
traffic mix ``traffic/<traffic>.json`` and its generator
``generators/<generator>.py``, and each metric's reader
``metrics/<metric>.py``. The program under test is
``repro_torch.serving.ServingEngine``, driven only through ``submit``
and ``step``; the benchmark wraps the engine instance's calls into its
layers (``_prefill``, ``_decode_one``, ``_swap_out``, ``_swap_in``, each
ending where the engine reads the token on the host or hands the lane
over) to stamp them on the host clock and, in a traced run, to mark them
for the profiler. Nothing of the program is edited.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
clock = time.perf_counter

#: the traced segment of a ``--trace 1`` window: its last SPAN, at most
#: SPAN_MAX_S seconds (a second of the profiler's events takes seconds to
#: stop and read: 150,000-300,000 device operations)
TRACE_SPAN, TRACE_SPAN_MAX_S = 0.4, 3.0


# -- the cell's files --------------------------------------------------------------

@dataclass
class Cell:
    name: str
    base: Path              # the benchmark's folder its files are found in
    workload: dict
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    end_to_end: list        # the metric entries that apply to this cell
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files from
    ``root/cardbench``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"cardbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(work)})")
    return make_cell(work[name], bench, root)


def make_cell(workload: dict, bench: dict, root: Path = ROOT) -> Cell:
    """A cell of ``workload`` (its ``name``, ``config`` and ``traffic``),
    the configuration one of ``bench``'s."""
    base = root / HERE.name
    name = workload["name"]
    conf = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    return Cell(name, base, workload,
                json.loads((root / conf["file"]).read_text()),
                json.loads((base / "traffic" / f"{workload['traffic']}.json")
                           .read_text()),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def load_module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py``, a file found by its name (metric names
    hold dots, so not imported as a dotted module)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_{name.replace('.', '_')}_{abs(hash(str(path)))}",
        path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def model_dims(config: dict, port: Optional[dict] = None) -> dict:
    """The widths the reference and the cost arithmetic read: the
    configuration's ``port`` section (the ModelConfig fields it runs) and
    its dtype."""
    m = dict(port or config["port"])
    m["dtype"] = config["dtype"]
    return m


# -- a run's record ------------------------------------------------------------

@dataclass
class Req:
    rid: int
    prompt: int
    due: float
    live: object = None             # the engine's LiveRequest
    t_prefill: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    lanes: list = field(default_factory=list)


@dataclass
class Record:
    cell: Cell
    seed: int
    seconds: float
    m: dict
    t_process: float
    start: float = 0.0
    end: float = 0.0
    reqs: dict = field(default_factory=dict)
    tokens: list = field(default_factory=list)      # host time of each read
    submissions: list = field(default_factory=list)  # (tick, rid, max_new)
    ticks: int = 0
    # (t0, t1, lane, pos or S, traced) of each layer call
    decodes: list = field(default_factory=list)
    prefills: list = field(default_factory=list)
    trace: Optional[dict] = None                    # trace.reduce()'s
    billed_gb: float = 0.0

    @property
    def setup_s(self) -> float:
        return self.start - self.t_process


# -- the served path ----------------------------------------------------------

class Marks:
    """Host-clock stamps of the engine's layer calls; in a traced segment
    also ``record_function`` spans for the profiler, and in the untraced
    segment before it (``timed`` a list) a pair of CUDA events around
    each layer call."""

    def __init__(self, rec: Record):
        self.rec = rec
        self.traced = False
        self.timed: Optional[list] = None

    def span(self, name: str):
        if self.timed is not None and name != "engine.step":
            return self._timed()
        if not self.traced:
            return nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextmanager
    def _timed(self):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self.timed.append((a, b))

    def wrap(self, engine) -> None:
        rec, span = self.rec, self.span
        prefill, decode = engine._prefill, engine._decode_one
        swap_out, swap_in = engine._swap_out, engine._swap_in

        def _prefill(i, req):
            r = rec.reqs[req.rid]
            t0 = clock()
            with span("prefill"):
                prefill(i, req)
            t1 = clock()
            r.t_prefill, r.t_first, r.t_last = t0, t1, t1
            r.lanes.append(i)
            rec.tokens.append(t1)
            rec.prefills.append((t0, t1, i, req.tokens.shape[1],
                                 self.traced))

        def _decode_one(i, req):
            pos = req.pos
            t0 = clock()
            with span("decode"):
                decode(i, req)
            t1 = clock()
            rec.reqs[req.rid].t_last = t1
            rec.tokens.append(t1)
            rec.decodes.append((t0, t1, i, pos, self.traced))

        def _swap_out(i, req):
            with span("swap_out"):
                swap_out(i, req)

        def _swap_in(i, req):
            with span("swap_in"):
                swap_in(i, req)
            rec.reqs[req.rid].lanes.append(i)

        engine._prefill, engine._decode_one = _prefill, _decode_one
        engine._swap_out, engine._swap_in = _swap_out, _swap_in


def busy(engine) -> bool:
    return bool(engine.pending or engine.fair_queue
                or any(s is not None for s in engine.slots))


def serve(engine, stream, prompts, rec: Record, tracer=None) -> None:
    """Offers the stream to ``engine`` for ``rec.seconds`` from now: an
    open loop submits each request when it is due, a closed loop keeps
    ``stream.clients`` requests in the engine. A request is submitted at
    the engine's current ``now_ms``, between ticks."""
    from repro_torch.serving.engine import LiveRequest

    n = len(stream.prompt)
    marks = Marks(rec)
    marks.wrap(engine)
    if tracer is not None:
        tracer.marks = marks
    nxt = 0

    def submit(due: float) -> None:
        nonlocal nxt
        rid = nxt
        live = LiveRequest(rid=rid, arrival_ms=engine.now_ms,
                           tokens=prompts[rid], max_new=stream.output[rid],
                           mem_gb=rec.billed_gb)
        rec.reqs[rid] = Req(rid, stream.prompt[rid], due, live)
        rec.submissions.append((rec.ticks, rid, stream.output[rid]))
        engine.submit(live)
        nxt += 1

    gc.collect()
    gc.disable()
    rec.start = start = clock()
    rec.end = end = start + rec.seconds
    try:
        while True:
            now = clock()
            if now >= end:
                break
            if stream.due_s is not None:
                while nxt < n and start + stream.due_s[nxt] <= now:
                    submit(start + stream.due_s[nxt])
            else:
                while nxt < n and nxt - len(engine.completed) \
                        < stream.clients:
                    submit(now)
            if not busy(engine):
                if nxt >= n:
                    raise RuntimeError(f"the stream of {n} requests ran out "
                                       f"{now - start:.1f} s into the window")
                if stream.due_s is not None:
                    time.sleep(max(0.0, min(start + stream.due_s[nxt],
                                            end) - clock()))
                continue
            if tracer is not None:
                tracer.tick(now - start)
            with marks.span("engine.step"):
                engine.step()
            rec.ticks += 1
    finally:
        gc.enable()
    if tracer is not None:
        tracer.close()


def make_prompts(stream, vocab: int, seed: int, device) -> list:
    """Each request's prompt ids, uniform over the vocabulary, drawn on the
    device from the seed in one call: (1, S) int64 views."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 1))
    flat = torch.randint(0, vocab, (sum(stream.prompt),), generator=gen,
                         dtype=torch.int64, device=device)
    out, at = [], 0
    for S in stream.prompt:
        out.append(flat[at:at + S].view(1, S))
        at += S
    return out


def seed_of(seed: int, part: int) -> int:
    """A seed of its own for each part of a run (weights 0, prompts 1,
    lengths 2, the check's sample 3), from any whole ``seed``."""
    return (abs(int(seed)) * 4 + part) % (1 << 62)


# -- building ---------------------------------------------------------------------

def program_config(cell: Cell, port: Optional[dict] = None):
    from repro_torch.configs import get_config
    return get_config(cell.config["port_arch"]).with_(
        **(port or cell.config["port"]))


def build(cell: Cell, seed: int, device, port: Optional[dict] = None,
          weights=None):
    """(engine, weights, m): the cell's weights drawn from the seed (into
    ``weights``' buffers where given), and the program's engine on them at
    the configuration's settings."""
    import torch
    from repro_torch.models import LM
    from repro_torch.serving.engine import ServingEngine

    from .weights import Weights
    cfg = program_config(cell, port)
    specs = {n: (tuple(p.shape), p.dtype) for n, p in
             LM(cfg, device="meta").named_parameters()}
    if weights is None:
        weights = Weights(specs, device,
                          dtype=getattr(torch, cell.config["dtype"]))
    params = weights.draw(seed_of(seed, 0))
    engine = ServingEngine(cfg, params, device=device,
                           **cell.config["engine"])
    sched = cell.config["scheduler_model"]
    if engine.step_ms != sched["modelled_step_ms"]:
        raise SystemExit(f"cardbench: the engine models {engine.step_ms} ms "
                         f"a step, the configuration "
                         f"{sched['modelled_step_ms']}")
    return engine, weights, model_dims(cell.config, port)


def warm_up(engine, stream, prompts) -> None:
    """The window's shapes before it opens: prefills at the stream's
    shortest, median and longest prompt (the allocator keeps the longest's
    blocks), and a lane's state saved and restored. Through the decoder,
    so the scheduler's state is untouched."""
    dec = engine.decoder
    order = sorted(range(len(stream.prompt)), key=lambda i: stream.prompt[i])
    for k in (order[0], order[len(order) // 2], order[-1]):
        dec.prefill(0, prompts[k])
    state = dec.save(0)
    dec.load(engine.n_slots - 1, state)
    del state


def free(engine, rec: Record) -> None:
    for r in rec.reqs.values():
        r.live.cache = None
    engine.decoder = None
    engine.slots = engine.fair_queue = engine.pending = None
    engine.lm = None


def log(msg: str) -> None:
    print(f"cardbench: {msg}", file=sys.stderr, flush=True)


def serve_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
               device="cuda", port: Optional[dict] = None,
               t_process: Optional[float] = None, faults=None,
               weights=None) -> tuple:
    """Set-up, warm-up and the window of one run; the engine freed after
    it. Returns (record, the engine's requests by id, weights, prompts,
    peak device bytes). ``faults(engine)``, where given, changes the
    engine before the window (the tests' faults)."""
    import torch

    from .trace import Tracer
    t_process = clock() if t_process is None else t_process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    gen = load_module("generators", cell.traffic["generator"], cell.base)
    stream = gen.make(cell.traffic, seed_of(seed, 2))
    log(f"imports and traffic {clock() - t_process:.3f} s")
    engine, weights, m = build(cell, seed, device, port, weights)
    prompts = make_prompts(stream, m["vocab"], seed, device)
    log(f"weights ({weights.nbytes / 1e9:.3f} GB) and engine "
        f"{clock() - t_process:.3f} s")
    rec = Record(cell, seed, seconds, m, t_process,
                 billed_gb=cell.config["billing"]["billed_gb"])
    warm_up(engine, stream, prompts)
    if faults is not None:
        faults(engine)
    tracer = Tracer(seconds, on_card) if trace else None
    if tracer is not None:
        tracer.warm()
    if on_card:
        torch.cuda.synchronize()
    log(f"warm-up {clock() - t_process:.3f} s")
    serve(engine, stream, prompts, rec, tracer)
    if on_card:
        torch.cuda.synchronize()
    log(f"window: {rec.ticks} ticks, {len(rec.reqs)} requests submitted, "
        f"{sum(r.live.completion_ms is not None for r in rec.reqs.values())}"
        f" finished, closed {clock() - rec.end:.3f} s late")
    if tracer is not None:
        t = clock()
        rec.trace = tracer.reduce()
        log(f"trace: {len(rec.trace['kernels'])} device operations read in "
            f"{clock() - t:.3f} s; busy {rec.trace['busy_s']:.4f} s of "
            f"{rec.trace['window_s']:.4f} traced, untraced "
            f"{rec.trace['untraced']}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    programs = {rid: r.live for rid, r in rec.reqs.items()}
    free(engine, rec)
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return rec, programs, weights, prompts, peak


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", port: Optional[dict] = None,
             t_process: Optional[float] = None, faults=None) -> dict:
    """One run: returns the result line's dict (with its ``checks``)."""
    import torch

    from . import check
    rec, programs, weights, prompts, peak = serve_cell(
        cell, seed, seconds, trace, device=device, port=port,
        t_process=t_process, faults=faults)
    on_card = torch.device(device).type == "cuda"
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", entry["name"], cell.base).read(rec)
        if value is not None:
            if not math.isfinite(value):
                raise SystemExit(f"cardbench: {entry['name']} read {value}")
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    t = clock()
    checks = check.run(rec, programs, weights.params, prompts)
    log(f"check {clock() - t:.3f} s; peak {peak / 1e9:.3f} GB")
    out = {"correct": all(c["value"] is not None and c["value"] <= c["limit"]
                          for c in checks.values()),
           "attempted": sum(r.due < rec.end for r in rec.reqs.values()),
           "failed": 0, "metrics": metrics,
           "device": device_info(on_card, peak)}
    if rec.trace is not None and on_card:
        out["device"]["busy_s"] = rec.trace["busy_s"]
        out["device"]["window_s"] = rec.trace["window_s"]
        out["breakdown"] = rec.trace["breakdown"]
    out["checks"] = checks
    return out


def device_info(on_card: bool, peak: int) -> dict:
    import torch
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
