"""The mc_cell kernel's design, on the CPU: ``emulate_cell`` below is a
line-for-line Python copy of the event loop of
``src/repro_torch/csrc/mc_cell.cu`` (binary-heap runqueues, the least
(end, cid) expiry, the FIFO queue as a tid range), held bit for bit
against the JAX package's scalar engine and the port's plain version;
and the paper grid's digests (``repro_torch/mc/paper_digests.py``)
against the scalar engine. Keep ``emulate_cell`` in step with the .cu.

``python tests/test_torch_mc_design.py`` prints the digest table of
paper_digests.py, recomputed from the scalar engine, with the seconds
each cell took it (about half a minute).
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro import FleetSpec, PolicySpec, Scenario, WorkloadSpec  # noqa: E402
from repro.traces import TraceSpec  # noqa: E402
from repro_torch.kernels.mc_cell import (CTX_SWITCH_MS, event_caps,  # noqa: E402
                                         run_grid_plain, slice_table)
from repro_torch.mc import paper_digests as pd  # noqa: E402
from repro_torch.mc.engine import Cell, _bucket, pack  # noqa: E402
from repro_torch.traces import TraceSpec as PortTraceSpec  # noqa: E402
from repro_torch.traces import generate_workload  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version steps through thousands of tiny tensor ops: torch's
    intra-op threads only spin on them, and beside other test workers
    they slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scalar_paper_digests(seeds, policies=pd.POLICIES, seconds=None):
    """{(policy, seed): digest} of the scalar engine's tasks; the seconds
    each repro.run took go into ``seconds`` if given."""
    out = {}
    for seed in seeds:
        for policy in policies:
            sc = Scenario(
                workload=WorkloadSpec(kind="azure", trace=TraceSpec(seed=seed)),
                fleet=FleetSpec(cores_per_node=50),
                policy=PolicySpec(name=policy, kw=pd.paper_kw(policy)))
            t0 = time.perf_counter()
            tasks = repro.run(sc).raw.tasks
            if seconds is not None:
                seconds[policy, seed] = time.perf_counter() - t0
            out[(policy, seed)] = pd.cell_digest(tasks)
    return out


EPS = 1e-9
INF = float("inf")


def py_min(a, b):
    return b if b < a else a


def py_max(a, b):
    return b if b > a else a


def emulate_cell(arr, service, n, nf, limit, C, cap):
    """mc_cell_kernel for one cell, statement for statement."""
    N = len(arr)
    slices = slice_table()
    K = len(slices) - 1
    rem, vr, cpu = list(service), [0.0] * N, [0.0] * N
    fr, comp = [math.nan] * N, [math.nan] * N
    npre, nctx, nmig = [0] * N, [0] * N, [0] * N
    hv = [[0.0] * N for _ in range(C)]
    hs = [[0] * N for _ in range(C)]
    ht = [[0] * N for _ in range(C)]
    end, clen, minvr = [INF] * C, [0.0] * C, [0.0] * C
    cur, last, seqc, rqn = [-1] * C, [-1] * C, [0] * C, [0] * C

    def less(v, s, pv, ps):
        return v < pv or (v == pv and s < ps)

    def rq_push(c, v, s, k):
        i = rqn[c]
        rqn[c] += 1
        while i > 0:
            p = (i - 1) >> 1
            if not less(v, s, hv[c][p], hs[c][p]):
                break
            hv[c][i], hs[c][i], ht[c][i] = hv[c][p], hs[c][p], ht[c][p]
            i = p
        hv[c][i], hs[c][i], ht[c][i] = v, s, k

    def rq_pop(c):
        v, k = hv[c][0], ht[c][0]
        rqn[c] -= 1
        m_ = rqn[c]
        if m_ == 0:
            return v, k
        lv, ls, lt = hv[c][m_], hs[c][m_], ht[c][m_]
        i = 0
        while True:
            l_ = 2 * i + 1
            if l_ >= m_:
                break
            m = l_
            if l_ + 1 < m_ and less(hv[c][l_ + 1], hs[c][l_ + 1], hv[c][l_],
                                    hs[c][l_]):
                m = l_ + 1
            if not less(hv[c][m], hs[c][m], lv, ls):
                break
            hv[c][i], hs[c][i], ht[c][i] = hv[c][m], hs[c][m], ht[c][m]
            i = m
        hv[c][i], hs[c][i], ht[c][i] = lv, ls, lt
        return v, k

    def start_chunk(c, k, t, lim):
        cx = 0.0 if last[c] == k else CTX_SWITCH_MS
        if math.isnan(fr[k]):
            fr[k] = t
        run = py_max(py_min(rem[k], lim), EPS)
        cur[c], clen[c], end[c] = k, run, (t + cx) + run
        if cx > 0.0:
            nctx[k] += 1

    def cfs_pick(c, t):
        if rqn[c] == 0:
            return
        v, k = rq_pop(c)
        minvr[c] = py_max(minvr[c], v)
        start_chunk(c, k, t, slices[min(rqn[c], K)])

    ncfs = C - nf
    budget = py_max(limit - 0.0, 0.01)
    ev = ptr = qh = rr = rrc = done = 0
    capped = False
    while True:
        cc, tc = -1, INF
        for c in range(C):
            if end[c] < tc:
                tc, cc = end[c], c
        arrive = ptr < n and (cc < 0 or arr[ptr] <= tc)
        if not arrive and cc < 0:
            break
        if ev >= cap:
            capped = True
            break
        ev += 1
        if arrive:
            k, t = ptr, arr[ptr]
            ptr += 1
            if nf > 0:
                for c in range(nf):
                    if cur[c] < 0:
                        start_chunk(c, qh, t, budget)
                        qh += 1
                        break
            else:
                s0, rr = rr, (rr + 1) % C
                best, best_nr = -1, 0
                for i in range(C):
                    c = (s0 + i) % C
                    nr = rqn[c] + (1 if cur[c] >= 0 else 0)
                    if nr == 0:
                        best = c
                        break
                    if best < 0 or nr < best_nr:
                        best, best_nr = c, nr
                vr[k] = py_max(vr[k], minvr[best])
                rq_push(best, vr[k], seqc[best], k)
                seqc[best] += 1
                if cur[best] < 0:
                    cfs_pick(best, t)
            continue
        c, t = cc, tc
        k, L = cur[c], clen[c]
        r2 = rem[k] - L
        cpu[k] = cpu[k] + L
        last[c], cur[c], end[c] = k, -1, INF
        if r2 <= EPS:
            rem[k], comp[k] = 0.0, t
            done += 1
        else:
            rem[k] = r2
            if c < nf:
                npre[k] += 1
                nmig[k] += 1
                tgt = nf + rrc % (ncfs if ncfs > 0 else 1)
                rrc += 1
                vr[k] = py_max(vr[k], minvr[tgt])
                rq_push(tgt, vr[k], seqc[tgt], k)
                seqc[tgt] += 1
                if cur[tgt] < 0:
                    cfs_pick(tgt, t)
            else:
                vr[k] = vr[k] + L
                npre[k] += 1
                rq_push(c, vr[k], seqc[c], k)
                seqc[c] += 1
        if c < nf:
            if qh < ptr:
                start_chunk(c, qh, t, budget)
                qh += 1
        else:
            cfs_pick(c, t)
    return dict(completion=comp, first_run=fr, cpu_time=cpu,
                preemptions=npre, ctx_switches=nctx, migrations=nmig,
                ok=not capped and done == n, n_events=ev)


def emulate(policy, n_cores, tasks, kw=None):
    arr, svc, n, nf, lim = pack([Cell(policy, n_cores, tasks, kw or {})],
                                _bucket(len(tasks)))
    cap = int(event_caps(torch.from_numpy(svc), torch.from_numpy(n))[0])
    return emulate_cell(arr[0].tolist(), svc[0].tolist(), int(n[0]),
                        int(nf[0]), float(lim[0]), n_cores, cap)


def as_digest(out, n):
    return [(i, repr(out["completion"][i]), out["preemptions"][i],
             out["ctx_switches"][i], repr(out["first_run"][i]),
             out["migrations"][i], repr(out["cpu_time"][i]))
            for i in range(n)]


def scalar_digest(raw):
    return sorted((t.tid, repr(t.completion), t.preemptions, t.ctx_switches,
                   repr(t.first_run), t.migrations, repr(t.cpu_time))
                  for t in raw.tasks)


def test_slice_table_is_the_helper():
    from repro.core.events import cfs_slice_ms
    table = slice_table()
    assert table == [cfs_slice_ms(nr, 24.0, 3.0) for nr in range(len(table))]
    assert table[-1] == 3.0
    assert all(cfs_slice_ms(nr, 24.0, 3.0) == 3.0
               for nr in range(len(table), 5000))


SMOKE = dict(minutes=1, invocations_per_min=60.0, n_functions=10)


@pytest.mark.parametrize("policy, n_cores, spec, kw", [
    ("fifo", 4, dict(SMOKE, seed=0), {}),
    ("cfs", 4, dict(SMOKE, seed=0), {}),
    ("hybrid", 4, dict(SMOKE, seed=0), {}),
    ("cfs", 1, dict(SMOKE, seed=1), {}),
    ("hybrid", 4, dict(SMOKE, seed=2), {"n_fifo": 1, "time_limit_ms": 40.0}),
    ("hybrid", 4, dict(SMOKE, seed=2), {"n_fifo": 3, "time_limit_ms": 1e-3}),
    ("cfs", 16, dict(minutes=1, invocations_per_min=600.0, n_functions=40,
                     seed=0), {}),
    ("hybrid", 16, dict(minutes=1, invocations_per_min=600.0,
                        n_functions=40, seed=0), {"n_fifo": 15}),
], ids=["fifo", "cfs", "hybrid", "cfs-1core", "hybrid-n_fifo=1",
        "hybrid-n_fifo=3-tiny-limit", "cfs-16", "hybrid-16-n_fifo=15"])
def test_kernel_design_matches_scalar_engine(policy, n_cores, spec, kw):
    raw = repro.run(Scenario(
        workload=WorkloadSpec(kind="azure", trace=TraceSpec(**spec)),
        fleet=FleetSpec(cores_per_node=n_cores),
        policy=PolicySpec(name=policy, kw=kw))).raw
    tasks = generate_workload(PortTraceSpec(**spec)).tasks
    out = emulate(policy, n_cores, tasks, kw)
    assert out["ok"]
    assert as_digest(out, len(tasks)) == scalar_digest(raw)


def test_kernel_design_matches_plain_version_with_events():
    """The emulated kernel against the plain version on one grid:
    every output and the event count."""
    tasks = generate_workload(PortTraceSpec(**SMOKE, seed=3)).tasks
    cells = [("fifo", {}), ("cfs", {}), ("hybrid", {}),
             ("hybrid", {"n_fifo": 1, "time_limit_ms": 10.0})]
    arrays = pack([Cell(p, 4, tasks, kw) for p, kw in cells],
                  _bucket(len(tasks)))
    plain = run_grid_plain(*map(torch.from_numpy, arrays), n_cores=4)
    for b, (policy, kw) in enumerate(cells):
        out = emulate(policy, 4, tasks, kw)
        assert out["n_events"] == int(plain["n_events"][b])
        assert out["ok"] and bool(plain["ok"][b])
        for k in ("completion", "first_run", "cpu_time"):
            got = np.array(out[k])
            assert np.array_equal(got.view(np.int64),
                                  plain[k][b].numpy().view(np.int64))
        for k in ("preemptions", "ctx_switches", "migrations"):
            assert out[k] == plain[k][b].tolist()


@pytest.mark.parametrize("policy", pd.POLICIES)
def test_paper_digests_match_scalar_engine_at_seed_0(policy):
    """paper_digests.py's seed-0 rows, recomputed from the scalar engine
    (the cfs cell takes ~6 s)."""
    assert scalar_paper_digests([0], [policy]) == \
        {(policy, 0): pd.DIGESTS[policy, 0]}
    assert set(pd.DIGESTS) == {(p, s) for p in pd.POLICIES
                               for s in pd.SEEDS}


def test_paper_cells_follow_the_config():
    cells = pd.paper_cells(seeds=(0,))
    assert [c.policy for c in cells] == list(pd.POLICIES)
    assert all(c.n_cores == 50 for c in cells)
    assert len(cells[0].tasks) == 12643
    assert cells[2].kw == {"n_fifo": 25, "time_limit_ms": 1633.0}


if __name__ == "__main__":
    secs = {}
    for key, d in scalar_paper_digests(pd.SEEDS, seconds=secs).items():
        print(f"    {key!r}: \"{d}\",  # scalar engine {secs[key]:.2f} s")
