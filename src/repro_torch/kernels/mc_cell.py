"""The batched Monte-Carlo engine's cell: a grid of single-node scheduler
trajectories (fifo, cfs or hybrid with a static time limit), each run to
its end, in f64.

Counterpart of the jitted ``vmap(while_loop)`` program of the JAX
package, ``make_cell_kernel`` (``src/repro/mc/kernels.py:112``).
:func:`run_grid_plain` is the plain PyTorch version, vectorised over the
cell axis as the JAX program is; :func:`mc_cell_cuda` launches the
hand-written kernel ``csrc/mc_cell.cu``, one event loop a cell, walked by
one warp whose lanes share the scans over the cores. Both
reproduce the scalar engine's per-task observables bit for bit, and each
other's, ``n_events`` included.

Inputs (one row a cell): ``arrival`` and ``service`` f64 (B, N), the live
prefix of ``n_tasks`` slots in tid order (arrivals non-decreasing);
``n_fifo`` int32 (B,) selects the policy (C: plain FIFO, 0: pure CFS,
else hybrid), ``limit`` f64 (B,) the hybrid's time limit (inf where
unused). Outputs: ``completion``, ``first_run``, ``cpu_time`` f64 (B, N),
NaN / 0 past the live prefix; ``preemptions``, ``ctx_switches``,
``migrations`` int32 (B, N); ``ok`` bool (B,), ``n_iters`` and
``n_events`` int64 (B,).
"""
from __future__ import annotations

import torch

from ..core.events import (cfs_slice_ms, chunk_completes, chunk_end_ms,
                           chunk_run_ms, fifo_budget_ms)
from . import build
from .common import check_cuda_tensor, require, stream_of

NAME = "mc_cell"
launches = 0

# The default Linux knobs of the regime (repro.mc.kernels:82-84).
SCHED_LATENCY_MS = 24.0
MIN_GRANULARITY_MS = 3.0
CTX_SWITCH_MS = 0.06
MAX_CORES = 4096    # 44 bytes of shared memory a core in the kernel

_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64
_INF = float("inf")


def event_caps(service: torch.Tensor, n_tasks: torch.Tensor) -> torch.Tensor:
    """Events a cell may take before it is cut (int64, (B,)). A task has at
    most an arrival, one budget expiry on a FIFO core, ceil(service /
    MIN_GRANULARITY_MS) CFS slice expiries (every slice but the last runs
    a full slice of at least the granularity) and its completion; the cap
    allows one more event a task and 64 a cell."""
    live = torch.arange(service.shape[1], device=service.device)[None, :] \
        < n_tasks[:, None]
    per = 4 + torch.ceil(service / MIN_GRANULARITY_MS).to(_I64)
    return 64 + torch.where(live, per, 0).sum(1)


def slice_table() -> list[float]:
    """``cfs_slice_ms(nr)`` for nr = 0..K, K the least queue length whose
    slice is the granularity: ``lat / nr`` only falls as nr grows, so every
    longer queue gets the granularity too. The kernel reads its slices
    here and divides nothing."""
    table = [cfs_slice_ms(0, SCHED_LATENCY_MS, MIN_GRANULARITY_MS)]
    while len(table) < 2 or table[-1] != MIN_GRANULARITY_MS:
        table.append(cfs_slice_ms(len(table), SCHED_LATENCY_MS,
                                  MIN_GRANULARITY_MS))
    return table


def cfs_slice_plain(nr: torch.Tensor) -> torch.Tensor:
    """``cfs_slice_ms`` on a tensor of queue lengths, in f64. The latency
    goes in as a tensor: PyTorch computes a Python float divided by a
    tensor as the tensor's reciprocal times the float, which is not the
    IEEE quotient (24.0 / 5 would come out as 4.800000000000001)."""
    lat = torch.tensor(SCHED_LATENCY_MS, dtype=_F64, device=nr.device)
    return cfs_slice_ms(nr, lat, MIN_GRANULARITY_MS, _max=_tmax)


def _pair(a, b):
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    return (torch.as_tensor(a, dtype=_F64, device=dev),
            torch.as_tensor(b, dtype=_F64, device=dev))


def _tmin(a, b):
    return torch.minimum(*_pair(a, b))


def _tmax(a, b):
    return torch.maximum(*_pair(a, b))


def run_grid_plain(arrival: torch.Tensor, service: torch.Tensor,
                   n_tasks: torch.Tensor, n_fifo: torch.Tensor,
                   limit: torch.Tensor, *, n_cores: int) -> dict:
    """One event a cell a step (the JAX program's one-event micro step):
    every CFS core whose expiry comes before the cell's next arrival and
    FIFO expiry expires and picks (CFS cores touch only their own state
    between those), else the earliest FIFO-group expiry, else the next
    arrival; in the scalar heap's order (time, then arrivals, then core
    id). Runqueue picks are the least (vruntime, seq) over the task slots.
    Per-task state has a sink column at index N that masked writes go to.
    """
    B, N = arrival.shape
    C, dev = n_cores, arrival.device
    rows = torch.arange(B, device=dev)
    rows_c = rows[:, None].expand(B, C)
    cids = torch.arange(C, device=dev)
    slots = torch.arange(N, device=dev)[None, :]
    n = n_tasks.to(_I64)
    nf = n_fifo.to(_I64)
    is_fifo = cids[None, :] < nf[:, None]
    n_cfs = (C - nf).clamp(min=1)
    budget = fifo_budget_ms(limit.to(_F64), 0.0, _max=_tmax)[:, None] \
        .expand(B, C)
    caps = event_caps(service, n)
    no_ctx = torch.tensor(0.0, dtype=_F64, device=dev)
    ctx_ms = torch.tensor(CTX_SWITCH_MS, dtype=_F64, device=dev)

    def tasks(fill, dtype):
        return torch.full((B, N + 1), fill, dtype=dtype, device=dev)

    rem = tasks(0.0, _F64)
    rem[:, :N] = service
    vr, cpu = tasks(0.0, _F64), tasks(0.0, _F64)
    fr, comp = tasks(float("nan"), _F64), tasks(float("nan"), _F64)
    seq, qcore = tasks(0, _I64), tasks(-1, _I64)
    onrq = tasks(False, torch.bool)
    npre, nctx, nmig = tasks(0, _I64), tasks(0, _I64), tasks(0, _I64)

    def core(fill, dtype):
        return torch.full((B, C), fill, dtype=dtype, device=dev)

    cur, last = core(-1, _I64), core(-1, _I64)
    end, clen, minvr = core(_INF, _F64), core(0.0, _F64), core(0.0, _F64)
    seqc, rqn = core(0, _I64), core(0, _I64)
    ptr, qh = torch.zeros_like(n), torch.zeros_like(n)
    rr, rrc = torch.zeros_like(n), torch.zeros_like(n)
    ev, it = torch.zeros_like(n), torch.zeros_like(n)

    def sink(k, m):
        return torch.where(m, k, N)

    def get(t, k):                       # k: (B,) or (B, C) slot indices
        return t.gather(1, k.clamp(0, N).reshape(B, -1)).reshape(k.shape)

    def put(t, k, val, m):
        r = rows if k.dim() == 1 else rows_c
        t.index_put_((r, sink(k, m)), torch.as_tensor(val, dtype=t.dtype,
                                                      device=dev)
                     .expand(k.shape))

    def onehot(c, m):
        return (cids[None, :] == c[:, None]) & m[:, None]

    def start(m, k, t, lim):
        """_start_chunk on the cores of m (B, C): task k at t under lim."""
        nonlocal cur, end, clen
        ctx = torch.where(last == k, no_ctx, ctx_ms)
        put(fr, k, t, m & torch.isnan(get(fr, k)))
        put(nctx, k, get(nctx, k) + 1, m & (ctx > 0.0))
        run = chunk_run_ms(get(rem, k), lim, _min=_tmin, _max=_tmax)
        cur = torch.where(m, k, cur)
        end = torch.where(m, chunk_end_ms(t, ctx, run), end)
        clen = torch.where(m, run, clen)

    def cfs_pick(m, t):
        """pick_next on the CFS cores of m: pop the least (vruntime, seq)
        of each core's queue, slice from the length after the pop."""
        nonlocal minvr, rqn
        if not bool(m.any()):
            return
        # each queued slot keyed by its core; column C collects the rest
        qc = torch.where(onrq[:, :N], qcore[:, :N], C)
        m = m & (torch.zeros(B, C + 1, dtype=_I64, device=dev)
                 .scatter_add_(1, qc, torch.ones_like(qc))[:, :C] > 0)
        if not bool(m.any()):
            return
        v = vr[:, :N]
        vmin = torch.full((B, C + 1), _INF, dtype=_F64, device=dev) \
            .scatter_reduce_(1, qc, v, "amin")
        tie = (qc < C) & (v == vmin.gather(1, qc))
        big = torch.iinfo(_I64).max
        skey = torch.where(tie, seq[:, :N], big)
        smin = torch.full((B, C + 1), big, dtype=_I64, device=dev) \
            .scatter_reduce_(1, qc, skey, "amin")
        hit = tie & (skey == smin.gather(1, qc))
        k = torch.zeros(B, C + 1, dtype=_I64, device=dev).scatter_reduce_(
            1, torch.where(hit, qc, C), slots.expand(B, N), "amax")[:, :C]
        vmin = vmin[:, :C]
        put(onrq, k, False, m)
        minvr = torch.where(m, _tmax(minvr, vmin), minvr)
        rqn = rqn - m.to(_I64)
        start(m, k, t, cfs_slice_plain(rqn))

    def push(k, c, v, m):
        """rq_push of tasks k (B,) onto cores c (B,) for the cells of m."""
        nonlocal seqc, rqn
        put(vr, k, v, m)
        put(seq, k, seqc[rows, c.clamp(max=C - 1)], m)
        put(qcore, k, c, m)
        put(onrq, k, True, m)
        om = onehot(c, m).to(_I64)
        seqc, rqn = seqc + om, rqn + om

    def cfs_advance(m):
        """_run_core on every CFS core of m (B, C), then its pick."""
        nonlocal cur, end, clen, last, seqc, rqn
        k = sink(cur, m)
        L, t = clen, end
        r = get(rem, k)
        d = chunk_completes(r, L)
        pb, de = m & ~d, m & d
        put(rem, k, torch.where(d, 0.0, r - L), m)
        put(cpu, k, get(cpu, k) + L, m)
        put(comp, k, t, de)
        put(vr, k, get(vr, k) + L, pb)
        put(npre, k, get(npre, k) + 1, pb)
        put(seq, k, seqc, pb)
        put(qcore, k, cids[None, :].expand(B, C), pb)
        put(onrq, k, True, pb)
        seqc, rqn = seqc + pb.to(_I64), rqn + pb.to(_I64)
        last = torch.where(m, cur, last)
        cur = torch.where(m, -1, cur)
        end = torch.where(m, _INF, end)
        clen = torch.where(m, 0.0, clen).to(_F64)
        cfs_pick(m, t)

    def fifo_advance(m, c, t):
        """_run_core on FIFO core c (B,) of the cells of m at t (B,)."""
        nonlocal cur, end, clen, last, rrc, qh
        cm = onehot(c, m)
        k = sink(cur[rows, c], m)
        L = clen[rows, c]
        r = get(rem, k)
        d = chunk_completes(r, L)
        put(rem, k, torch.where(d, 0.0, r - L), m)
        put(cpu, k, get(cpu, k) + L, m)
        put(comp, k, t, m & d)
        last = torch.where(cm, cur, last)
        cur = torch.where(cm, -1, cur)
        end = torch.where(cm, _INF, end)
        clen = torch.where(cm, 0.0, clen).to(_F64)
        # over the limit: preempt, migrate round robin onto a CFS core
        mig = m & ~d
        tgt = nf + rrc % n_cfs
        put(npre, k, get(npre, k) + 1, mig)
        put(nmig, k, get(nmig, k) + 1, mig)
        rrc = rrc + mig.to(_I64)
        push(k, tgt, _tmax(get(vr, k), minvr[rows, tgt.clamp(max=C - 1)]),
             mig)
        tc = t[:, None].expand(B, C)
        cfs_pick(onehot(tgt, mig) & (cur < 0), tc)
        # then the FIFO core takes the global queue's head
        q = m & (qh < ptr)
        start(onehot(c, q), qh[:, None].expand(B, C), tc, budget)
        qh = qh + q.to(_I64)

    def arrival_step(m, t):
        nonlocal ptr, qh, rr
        k = sink(ptr, m)
        ptr = ptr + m.to(_I64)
        tc = t[:, None].expand(B, C)
        # hybrid / FIFO: join the global queue; the first idle FIFO core
        # takes its head
        idle = is_fifo & (cur < 0)
        go = m & (nf > 0) & idle.any(1)
        start(onehot(idle.to(torch.uint8).argmax(1), go),
              qh[:, None].expand(B, C), tc, budget)
        qh = qh + go.to(_I64)
        # pure CFS: least loaded, ties to the first from the rotating start
        cf = m & (nf == 0)
        nr = rqn + (cur >= 0).to(_I64)
        rot = (cids[None, :] - rr[:, None]) % C
        cand = nr == nr.min(1).values[:, None]
        rmin = torch.where(cand, rot, C).min(1).values
        best = (cand & (rot == rmin[:, None])).to(torch.uint8).argmax(1)
        rr = torch.where(cf, (rr + 1) % C, rr)
        push(k, best, _tmax(get(vr, k), minvr[rows, best]), cf)
        cfs_pick(onehot(best, cf) & (cur < 0), tc)

    while True:
        act = ((ptr < n) | (cur >= 0).any(1)) & (ev < caps)
        if not bool(act.any()):
            break
        it = it + act.to(_I64)
        ta = torch.where(ptr < n, arrival[rows, ptr.clamp(max=N - 1)], _INF)
        busy_f = is_fifo & (cur >= 0)
        e_f = torch.where(busy_f, end, _INF)
        tf = e_f.min(1).values
        fcid = (busy_f & (e_f == tf[:, None])).to(torch.uint8).argmax(1)
        before = (end < ta[:, None]) & (
            (end < tf[:, None])
            | ((end == tf[:, None]) & (cids[None, :] < fcid[:, None])))
        elig = act[:, None] & ~is_fifo & (cur >= 0) & before
        any_cfs = elig.any(1)
        do_f = act & busy_f.any(1) & ~any_cfs & (tf < ta)
        do_a = act & ~any_cfs & ~do_f & (ptr < n)
        ev = ev + elig.sum(1) + do_f.to(_I64) + do_a.to(_I64)
        if bool(any_cfs.any()):
            cfs_advance(elig)
        if bool(do_f.any()):
            fifo_advance(do_f, fcid, tf)
        if bool(do_a.any()):
            arrival_step(do_a, ta)

    live = torch.arange(N, device=dev)[None, :] < n[:, None]
    ok = (~torch.isnan(comp[:, :N]) | ~live).all(1)
    return {"completion": comp[:, :N], "first_run": fr[:, :N],
            "preemptions": npre[:, :N].to(_I32),
            "ctx_switches": nctx[:, :N].to(_I32),
            "migrations": nmig[:, :N].to(_I32), "cpu_time": cpu[:, :N],
            "ok": ok, "n_iters": it, "n_events": ev}


def mc_cell_cuda(arrival: torch.Tensor, service: torch.Tensor,
                 n_tasks: torch.Tensor, n_fifo: torch.Tensor,
                 limit: torch.Tensor, *, n_cores: int) -> dict:
    """The kernel: one warp a cell, up to 8 cells a block.
    ``arrival``/``service`` f64 (B, N), ``n_tasks``/``n_fifo`` int32 (B,),
    ``limit`` f64 (B,), all contiguous on the card. Needs B * n_cores *
    N * 16 bytes of runqueue space. ``n_iters`` is ``n_events``: the
    kernel retires one event a trip."""
    global launches
    for arg, t, dt in (("arrival", arrival, _F64), ("service", service, _F64),
                       ("n_tasks", n_tasks, _I32), ("n_fifo", n_fifo, _I32),
                       ("limit", limit, _F64)):
        check_cuda_tensor(t, NAME, arg)
        require(t.dtype == dt, NAME, f"{arg} must be {dt}, got {t.dtype}")
    require(arrival.dim() == 2 and service.shape == arrival.shape, NAME,
            "arrival and service must be (B, N) of one shape")
    B, N = arrival.shape
    require(all(t.shape == (B,) for t in (n_tasks, n_fifo, limit)), NAME,
            f"n_tasks, n_fifo and limit must be ({B},)")
    require(1 <= n_cores <= MAX_CORES, NAME,
            f"n_cores must be in [1, {MAX_CORES}], got {n_cores}")
    require(B >= 1 and 1 <= N < 2 ** 31, NAME, f"unsupported B={B} N={N}")
    dev = arrival.device
    rem, vr = service.clone(), torch.zeros_like(service)
    completion = torch.full_like(arrival, float("nan"))
    first_run = torch.full_like(arrival, float("nan"))
    cpu_time = torch.zeros_like(arrival)
    counts = [torch.zeros((B, N), dtype=_I32, device=dev) for _ in range(3)]
    # runqueue slots of 16 bytes (vruntime, push counter, task), N a core
    rq = torch.empty((B, n_cores, N, 2), dtype=_F64, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    n_events = torch.empty(B, dtype=_I64, device=dev)
    caps = event_caps(service, n_tasks)
    slices = torch.tensor(slice_table(), dtype=_F64, device=dev)
    rc = build.library().repro_mc_cell(
        arrival.data_ptr(), n_tasks.data_ptr(), n_fifo.data_ptr(),
        limit.data_ptr(), caps.data_ptr(), rem.data_ptr(), vr.data_ptr(),
        rq.data_ptr(), completion.data_ptr(), first_run.data_ptr(),
        cpu_time.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
        counts[2].data_ptr(), ok.data_ptr(), n_events.data_ptr(),
        slices.data_ptr(), len(slices) - 1, B, n_cores, N, CTX_SWITCH_MS, stream_of(arrival))
    build.check(rc, NAME)
    launches += 1
    return {"completion": completion, "first_run": first_run,
            "preemptions": counts[0], "ctx_switches": counts[1],
            "migrations": counts[2], "cpu_time": cpu_time, "ok": ok,
            "n_iters": n_events.clone(), "n_events": n_events}
