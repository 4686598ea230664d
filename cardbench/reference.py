"""The plain reference: the same model and the same scheduler, written
again in plain PyTorch and Python from the configuration's description,
with no kernels, caches or batching. It imports nothing of the program.

Model (a uniform stack: attention, then a gated MLP or a top-k MoE, each
pre-normed, residuals added): the token embedding scaled by
sqrt(hidden); RMSNorm ``x rsqrt(mean(x^2) + eps) (1 + w)``; rotary
embedding on the two halves of head_dim; causal softmax attention with
grouped KV heads at 1/sqrt(head_dim); ``silu(h Wg) * (h Wu) Wd``; the MoE
router's softmax over all experts, the top k (ties to the lower index),
gates renormalised over them, each expert taking at most ``capacity``
assignments of a row in (token, k) order (:func:`capacity`), the rest
dropped; final norm and the head in float32. It runs in float32 with
TF32 off (``precision="f32"``), a sequence at a time and a layer at a
time, each layer's weights cast from the served tensors as it is reached.
``precision="fp8"`` is the control: float8 e4m3 wherever the program
holds bfloat16: every product's operands and output (per-tensor scale for
a weight, per-row for an activation), the residual stream after each add
and the embedding; the head's product and the logits stay float32, as
the program's.

Scheduler (:func:`replay`): the hybrid slot scheduler's decisions on
token counts alone, from a run's submission log: the FIFO lanes run a
request to completion unless its modelled time passes the time limit, the
95th percentile of the last 100 modelled execution times (linear
interpolation; the initial limit while none has completed), which moves
it to the fair-share lanes; a fair lane rotates its request out after
``fair_slice_steps`` steps when another waits; a lane that hands a
request over stalls for the modelled swap time.
"""
from __future__ import annotations

import math
from bisect import insort
from collections import deque

import torch


# -- model ------------------------------------------------------------------------

def capacity(m: dict, S: int) -> int:
    return max(int(S * m["top_k"] / m["n_experts"] * m["capacity_factor"]),
               1)


def fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a scale that maps its largest
    magnitude (over ``dim``, or the whole tensor) to 448, and back."""
    amax = (t.abs().amax() if dim is None else
            t.abs().amax(dim=dim, keepdim=True)).clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.low:
            return self.act(fp8(x, dim=-1) @ fp8(w))
        return x @ w

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation where the program holds it in the served dtype:
        rounded to float8 (per row) in the control, kept in float32
        otherwise."""
        return fp8(t, dim=-1) if self.low else t

    def head(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The logits, in float32 as the program computes them, from the
        final norm's output in the served (here: the control's) dtype."""
        return self.act(h) @ w.to(torch.float32)


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.to(torch.float32))


def rope(x, theta):
    """x (H, S, hd): the halves of hd rotated by position * theta^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[2]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, x, m, ops):
    S = x.shape[0]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    h = rmsnorm(x, p["norm"], m["norm_eps"])
    q = ops.mm(h, p["wq"]).view(S, H, hd).transpose(0, 1)
    k = ops.mm(h, p["wk"]).view(S, KV, hd).transpose(0, 1)
    v = ops.mm(h, p["wv"]).view(S, KV, hd).transpose(0, 1)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    G = H // KV
    k, v = k.repeat_interleave(G, 0), v.repeat_interleave(G, 0)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(H, S, hd, device=x.device)
    for h0 in range(0, H, 8):                   # 8 heads' scores at a time
        s = (q[h0:h0 + 8] / math.sqrt(hd)) @ k[h0:h0 + 8].transpose(1, 2)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[h0:h0 + 8] = s @ v[h0:h0 + 8]
    return ops.mm(out.transpose(0, 1).reshape(S, H * hd), p["wo"])


def mlp(p, x, m, ops):
    h = rmsnorm(x, p["norm"], m["norm_eps"])
    return ops.mm(torch.nn.functional.silu(ops.mm(h, p["w_gate"]))
                  * ops.mm(h, p["w_up"]), p["w_down"])


def moe(p, x, m, ops, prompt: int):
    """The first ``prompt`` positions are one prefill, whose assignments
    past an expert's capacity are dropped; each later position is a
    decode step of one token, whose K distinct experts take it whole."""
    S, d = x.shape
    E, K = m["n_experts"], m["top_k"]
    h = rmsnorm(x, p["norm"], m["norm_eps"])
    probs = torch.softmax(ops.mm(h, p["router"]), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    eids, gates = top.indices[:, :K], top.values[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    C = capacity(m, prompt)
    y = torch.zeros(S, d, device=x.device)
    flat = eids.reshape(-1)                     # (token, k) order
    for e in range(E):
        at = (flat == e).nonzero().flatten()
        at = torch.cat([at[at < prompt * K][:C], at[at >= prompt * K]])
        if at.numel() == 0:
            continue
        tok, kk = at // K, at % K
        he = h[tok]
        a = torch.nn.functional.silu(ops.mm(he, p["w_gate"][e])) \
            * ops.mm(he, p["w_up"][e])
        y.index_add_(0, tok, ops.mm(a, p["w_down"][e])
                     * gates[tok, kk][:, None])
    return y


def layer_params(params: dict, i: int) -> tuple[dict, str, dict]:
    attn = {k.rsplit(".", 1)[-1]: t for k, t in params.items()
            if k.startswith(f"layers.{i}.attn.")}
    for kind in ("mlp", "moe"):
        ffn = {k.rsplit(".", 1)[-1]: t for k, t in params.items()
               if k.startswith(f"layers.{i}.{kind}.")}
        if ffn:
            return attn, kind, ffn
    raise KeyError(f"layer {i} has no MLP or MoE")


@torch.no_grad()
def logits(params: dict, m: dict, tokens: torch.Tensor, score: list,
           precision: str = "f32", prompt: int = 0) -> torch.Tensor:
    """Float32 logits (len(score), V) at positions ``score`` of the
    sequence ``tokens`` (S,), through the whole stack: its first
    ``prompt`` positions (default: all) prefilled, the rest fed one at a
    time, as the engine serves a prompt and then its tokens."""
    prompt = prompt or tokens.shape[0]
    ops = Ops(precision)
    x = ops.act(params["embed"].to(torch.float32)[tokens]
                * math.sqrt(m["d_model"]))
    for i in range(m["n_layers"]):
        attn, kind, ffn = layer_params(params, i)
        x = ops.act(x + attention(attn, x, m, ops))
        x = ops.act(x + (moe(ffn, x, m, ops, prompt) if kind == "moe"
                         else mlp(ffn, x, m, ops)))
    h = rmsnorm(x[score], params["final_norm"], m["norm_eps"])
    head = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    return ops.head(h, head)


# -- scheduler -------------------------------------------------------------------

def percentile(sorted_vals: list, pct: float) -> float:
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    rank = pct / 100.0 * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class _Req:
    def __init__(self, rid, need):
        self.rid, self.need = rid, need
        self.made = 0
        self.cpu = self.vr = 0.0
        self.first = self.done_at = None
        self.preempt = 0


def swap_ms(m: dict, sched: dict, max_len: int) -> float:
    """The modelled lane swap: a lane's K/V cache out and back at the
    modelled bandwidth, plus the dispatch bubble."""
    nbytes = m["n_layers"] * 2 * m["n_kv_heads"] * m["head_dim"] \
        * max_len * 2
    return 2.0 * nbytes / sched["swap_bytes_per_s"] * 1000.0 \
        + sched["dispatch_bubble_ms"]


def replay(log: list, ticks: int, m: dict, engine: dict, sched: dict
           ) -> dict:
    """The scheduler's record after ``ticks`` ticks of the submissions in
    ``log`` [(tick, rid, tokens asked)]: rid -> (first run ms, completion
    ms or None, preemptions, tokens made)."""
    n, nf = engine["n_slots"], engine["n_fifo"]
    step, pen = sched["modelled_step_ms"], swap_ms(m, sched,
                                                   engine["max_len"])
    slice_ms = engine["fair_slice_steps"] * step
    window: deque = deque()
    ranked: list = []
    pending, fair = deque(), []
    slots, ready = [None] * n, [0.0] * n
    reqs, now, at = {}, 0.0, 0

    def limit():
        if not ranked:
            return engine["initial_limit_ms"]
        return percentile(ranked, engine["adapt_pct"])

    def record(dur):
        if len(window) == sched["limit_window"]:
            ranked.remove(window.popleft())
        window.append(dur)
        insort(ranked, dur)

    for t in range(ticks):
        while at < len(log) and log[at][0] == t:
            _, rid, need = log[at]
            reqs[rid] = _Req(rid, need)
            pending.append(reqs[rid])
            at += 1
        for i in range(nf):                     # admissions to FIFO lanes
            if slots[i] is None and pending and now >= ready[i]:
                r = pending.popleft()
                r.first = now if r.first is None else r.first
                r.made += 1                     # the prefill's token
                slots[i] = r
        for i in range(nf, n):                  # restores to fair lanes
            if slots[i] is None and fair and now >= ready[i]:
                fair.sort(key=lambda r: r.vr)
                slots[i] = fair.pop(0)
                ready[i] = now + pen
        now += step
        lim = limit()
        for i in range(n):
            r = slots[i]
            if r is None or now < ready[i]:
                continue
            r.made += 1
            r.cpu += step
            r.vr += step
            if r.made >= r.need:
                r.done_at = now
                record(now - r.first)
                slots[i] = None
                continue
            if (i < nf and r.cpu > lim) or (
                    i >= nf and r.cpu % slice_ms < step and fair):
                r.preempt += 1
                fair.append(r)
                slots[i] = None
                ready[i] = now + pen
    return {rid: (r.first, r.done_at, r.preempt, r.made)
            for rid, r in reqs.items()}
