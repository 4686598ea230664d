"""The ``llm`` workload: model replicas as serverless functions (own copy
of ``repro.serving.llm``; the same ``TraceSpec`` and model give the same
chunk tasks, float for float).

This is the ROADMAP's LLM-inference-as-FaaS mapping made concrete
(DESIGN.md Sec. 15):

* **replica <-> function** — every trace function becomes a model
  endpoint; a sandbox for it is a loaded replica lane (weights resident,
  KV block allocated), keyed by ``func_id`` in the ``ContainerPool``.
* **cold start = weight-load + compile** — instantiating a replica pays
  ``weights / weight_gbps`` of HBM load plus one compile, metered
  exactly like a sandbox boot: sampled once per instantiation, billed on
  the first chunk's wall-clock span (``Task.init_ms``).
* **warm state = KV/weights residency** — an idle replica held for the
  keep-alive window serves the next request of its endpoint without the
  load+compile; the pool's idle-memory integral prices that residency
  (provider-side warm-pool hold cost).
* **task = prefill/decode chunk** — a request is split into one
  run-to-completion prefill task plus decode chunks on the ideal
  streaming cadence; preempting a chunk inside the fair-share group
  costs the KV swap penalty (``request.preemption_penalty_ms``) —
  exactly the billed-span inflation the paper attributes to CFS.

Chunk arrivals follow the *ideal* token cadence (prefill service, then
each decode chunk as soon as its tokens could exist); queueing delay
therefore shows up as per-chunk slowdown rather than as pipeline
back-pressure, the same modelling level as the gateway's request
stream. Everything is deterministic for a fixed ``TraceSpec.seed``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

import numpy as np

from ..configs.base import ModelConfig
from ..core.containers import ContainerSpec
from ..core.events import Task
from ..traces.azure import TraceSpec
from ..traces.workload import generate_workload, scale_load
from .request import RequestSpec, kv_bytes, service_ms

BYTES_PER_PARAM = 2.0      # bf16 checkpoints
MB = 1024.0 * 1024.0


@dataclass(frozen=True)
class LLMSpec:
    """Everything needed to turn a trace into an LLM request stream.

    ``model`` is a registry arch name (``configs.registry``) or a
    ``ModelConfig``; keep it a string inside sweep cells so the spec
    stays trivially picklable.
    """

    model: Union[str, ModelConfig] = "deepseek-7b"
    seq_len: int = 4096             # KV budget per replica lane
    decode_chunk_tokens: int = 256  # 0 = whole decode as one task
    prompt_ratio: tuple = (2.0, 8.0)   # prompt = U(lo,hi) x decode tokens
    max_prompt: int = 8192
    # Replica (= sandbox) economics.
    weight_gbps: float = 20.0       # host->HBM weight streaming bandwidth
    compile_ms: float = 1500.0      # one-time compile on instantiation
    warm_replicas: int = 4          # idle replicas the warm pool may hold
    keepalive_ms: float = 30_000.0
    container_policy: str = "fixed"     # "off" | "fixed" | "histogram"

    def resolve_model(self) -> ModelConfig:
        if isinstance(self.model, ModelConfig):
            return self.model
        from ..configs.registry import get_config
        return get_config(self.model)

    # -- replica economics --------------------------------------------------
    def replica_mem_mb(self) -> float:
        cfg = self.resolve_model()
        return (approx_param_bytes(cfg)
                + kv_bytes(cfg, self.seq_len)) / MB

    def cold_start_ms(self) -> float:
        """Expected replica instantiation delay: stream the weights in,
        then compile. This becomes the pool's ``cold_base_ms`` (the
        per-GB slope is zeroed: the pool samples cold from the billed
        per-lane footprint, but weight load does not scale with it)."""
        cfg = self.resolve_model()
        weights_gb = approx_param_bytes(cfg) / 1e9
        return weights_gb / self.weight_gbps * 1000.0 + self.compile_ms

    def container_spec(self) -> ContainerSpec:
        """The sandbox layer this workload implies: capacity for
        ``warm_replicas`` idle lanes, cold = load + compile. Customize
        with ``dataclasses.replace`` before handing it to a Scenario."""
        return ContainerSpec(
            policy=self.container_policy,
            capacity_mb=self.warm_replicas * self.replica_mem_mb(),
            keepalive_ms=self.keepalive_ms,
            cold_base_ms=self.cold_start_ms(),
            cold_per_gb_ms=0.0)


def approx_param_bytes(cfg: ModelConfig,
                       bytes_per_param: float = BYTES_PER_PARAM) -> float:
    """Rough checkpoint size: embeddings + per-layer attention (or a
    4d^2 mixer stand-in for attention-free archs) + MLP, with every
    expert resident for MoE (a serving replica ships the full router
    fan-out). Good to ~10% for the registry archs — cold-start COST
    modelling, not a memory planner."""
    d, L = cfg.d_model, cfg.n_layers
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    if cfg.n_heads:
        mix = d * cfg.hd * cfg.n_heads * 2 + d * cfg.hd * cfg.n_kv_heads * 2
    else:
        mix = 4 * d * d
    mlp = 3 * d * cfg.d_ff * max(cfg.n_experts, 1)
    return float(emb + L * (mix + mlp)) * bytes_per_param


def llm_requests(spec: LLMSpec, trace: TraceSpec | None = None,
                 ) -> list[RequestSpec]:
    """Map the Azure-like arrival process onto inference requests: a
    trace function is a model endpoint, its calibrated CPU service time
    becomes a decode-token budget (same recipe as the gateway's
    ``requests_from_trace``), prompts are a uniform multiple of it."""
    trace = trace or TraceSpec()
    cfg = spec.resolve_model()
    w = generate_workload(trace)
    rng = np.random.default_rng(trace.seed + 11)
    mem_gb = spec.replica_mem_mb() / 1024.0
    reqs = []
    for t in w.tasks:
        decode = max(int(t.service / cfg.ms_per_token_decode), 1)
        prompt = int(min(decode * rng.uniform(*spec.prompt_ratio),
                         spec.max_prompt))
        reqs.append(RequestSpec(rid=t.tid, arrival_ms=t.arrival,
                                prompt_tokens=prompt, decode_tokens=decode,
                                mem_gb=mem_gb, func_id=t.func_id))
    return reqs


def request_chunks(cfg: ModelConfig, spec: LLMSpec, req: RequestSpec,
                   edf_slack: float = 2.0) -> list[Task]:
    """One request -> its prefill/decode chunk tasks (tids are per-
    request phase indices; ``llm_workload`` renumbers globally).

    The chunk services partition the request's modelled service time
    exactly: prefill carries the ``ms_per_ktoken_prefill`` share, the
    decode chunks split ``decode_tokens`` into ``decode_chunk_tokens``
    slices at ``ms_per_token_decode`` each.
    """
    prefill_ms = service_ms(cfg, req.prompt_tokens, 0)
    mem_mb = req.mem_gb * 1024.0
    chunk = spec.decode_chunk_tokens or req.decode_tokens
    n_chunks = max(1, math.ceil(req.decode_tokens / chunk))
    sizes = [chunk] * (n_chunks - 1) \
        + [req.decode_tokens - chunk * (n_chunks - 1)]
    out = []
    t0 = req.arrival_ms
    if prefill_ms > 0.0:
        out.append(Task(tid=0, arrival=t0, service=prefill_ms,
                        mem_mb=mem_mb, func_id=req.func_id,
                        deadline=t0 + edf_slack * prefill_ms))
        t0 += prefill_ms
    for tokens in sizes:
        svc = tokens * cfg.ms_per_token_decode
        out.append(Task(tid=len(out), arrival=t0, service=svc,
                        mem_mb=mem_mb, func_id=req.func_id,
                        deadline=t0 + edf_slack * svc))
        t0 += svc
    return out


def llm_workload(spec: LLMSpec, trace: TraceSpec | None = None,
                 load_scale: float = 1.0) -> tuple[list[Task], dict]:
    """Build the full ``llm`` task stream plus its roll-up metadata.

    Returns ``(tasks, meta)`` where ``meta`` carries what the summary
    schema needs and a chunk->request accounting (``n_requests`` is the
    $/1k-requests denominator — chunking must not inflate it).
    """
    trace = trace or TraceSpec()
    cfg = spec.resolve_model()
    reqs = llm_requests(spec, trace)
    chunks: list[Task] = []
    for req in reqs:
        for t in request_chunks(cfg, spec, req, trace.edf_slack):
            t.tid = len(chunks)     # provisional: request-stream order
            chunks.append(t)
    # Canonical ids: arrival order with the deterministic request-stream
    # order as the same-instant tie-break.
    chunks.sort(key=lambda t: (t.arrival, t.tid))
    for i, t in enumerate(chunks):
        t.tid = i
    if load_scale != 1.0:
        chunks = scale_load(chunks, load_scale)
    meta = {
        "model": cfg.name,
        "n_requests": len(reqs),
        "n_chunks": len(chunks),
        "replica_mem_mb": spec.replica_mem_mb(),
        "replica_cold_ms": spec.cold_start_ms(),
        "seq_len": spec.seq_len,
    }
    return chunks, meta
