"""The mc_cell kernel's design, on the CPU: ``emulate_cell`` below is a
line-for-line Python copy of the event loop of
``src/repro_torch/csrc/mc_cell.cu`` (one warp a cell: the scans over the
cores as the warp's reductions, emulated lane by lane -- the shuffle-xor
argmin tree of the next expiry, the ballot and first-set of the first
idle FIFO core, the two integer minima of the rotated least-loaded pick
-- and lane 0's serial rest: each core's runqueue a sorted ring, the
fused push and pick, the FIFO queue as a tid range), held bit for bit
against the JAX package's scalar engine and the port's plain version,
at core counts on the warp's lane boundaries and on forced ties; and
the paper grid's digests (``repro_torch/mc/paper_digests.py``) against
the scalar engine. Keep ``emulate_cell`` in step with the .cu.

``python tests/test_torch_mc_design.py`` prints the digest table of
paper_digests.py, recomputed from the scalar engine, with the seconds
each cell took it (about half a minute). ``tests/mc_push_census.py``
counts where ``emulate_cell``'s runqueue pushes land.
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
from conftest import mk_tasks  # noqa: E402
from repro_torch.core.events import Task  # noqa: E402
from repro_torch.kernels.mc_cell import (CTX_SWITCH_MS, event_caps,  # noqa: E402
                                         run_grid_plain, slice_table)
from repro_torch.launch.mc_time import long_queue_cells  # noqa: E402
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


LANES = 32
U32_MAX = 0xffffffff


def shfl_xor(vals, o):
    """__shfl_xor_sync: lane l reads lane l ^ o's value."""
    return [vals[lane ^ o] for lane in range(LANES)]


def ballot(preds):
    """__ballot_sync: bit l set where lane l's predicate holds."""
    return sum(1 << lane for lane, p in enumerate(preds) if p)


def ffs(m):
    """__ffs: one plus the index of the lowest set bit, 0 for none."""
    return (m & -m).bit_length()


def next_expiry(end, C):
    """The least (end, cid): each lane over its own cores (cid order,
    strict <), then the shuffle-xor tree of lexicographic minima; every
    lane ends with the same pair. cc = -1 when every core holds +inf."""
    e, i = [INF] * LANES, [C] * LANES
    for lane in range(LANES):
        for c in range(lane, C, LANES):
            if end[c] < e[lane]:
                e[lane], i[lane] = end[c], c
    o = 16
    while o > 0:
        oe, oi = shfl_xor(e, o), shfl_xor(i, o)
        for lane in range(LANES):
            if oe[lane] < e[lane] or (oe[lane] == e[lane]
                                      and oi[lane] < i[lane]):
                e[lane], i[lane] = oe[lane], oi[lane]
        o >>= 1
    assert len(set(zip(e, i))) == 1, "the tree left the lanes apart"
    return e[0], (i[0] if e[0] < INF else -1)


def first_idle(cur, nf):
    """A ballot a round of 32 cores; the first round with a bit wins."""
    base = 0
    while base < nf:
        m = ballot(base + lane < nf and cur[base + lane] < 0
                   for lane in range(LANES))
        if m:
            return base + ffs(m) - 1
        base += LANES
    return -1


def least_loaded(cur, rqn, C, s0):
    """The least (nr, (c - s0) mod C): a lane's own, then __reduce_min_sync
    of nr over the warp and of r over the lanes that hold it."""
    bn, br = [U32_MAX] * LANES, [U32_MAX] * LANES
    for lane in range(LANES):
        for c in range(lane, C, LANES):
            nr = rqn[c] + (1 if cur[c] >= 0 else 0)
            r = c - s0 if c >= s0 else c - s0 + C
            if nr < bn[lane] or (nr == bn[lane] and r < br[lane]):
                bn[lane], br[lane] = nr, r
    mn = min(bn)
    mr = min(br[lane] if bn[lane] == mn else U32_MAX for lane in range(LANES))
    best = s0 + mr
    return best if best < C else best - C


def emulate_cell(arr, service, n, nf, limit, C, cap, census=None):
    """mc_cell_kernel for one cell (one warp), statement for statement;
    the warp's reductions are the functions above, the rest is lane 0's.
    A ``census`` (a Counter) counts where each runqueue push lands:
    "empty", "back", "front", "walked" (with "steps", the slots the walk
    moves, each a dependent load in the kernel) or "picked" (the fused
    pick took the pushed task, which never joined)."""
    N = len(arr)
    slices = slice_table()
    K = len(slices) - 1
    rem, vr, cpu = list(service), [0.0] * N, [0.0] * N
    fr, comp = [math.nan] * N, [math.nan] * N
    npre, nctx, nmig = [0] * N, [0] * N, [0] * N
    rq = [[None] * N for _ in range(C)]   # a sorted ring of slots a core
    end, clen, minvr = [INF] * C, [0.0] * C, [0.0] * C
    cur, last, seqc, rqn = [-1] * C, [-1] * C, [0] * C, [0] * C
    rqh = [0] * C

    def less(x, y):
        """key_less on slots (v, seq, k)."""
        return x[0] < y[0] or (x[0] == y[0] and x[1] < y[1])

    def ring_at(h, j):
        i = h + j
        return i if i < N else i - N

    def rq_insert(q, h, n, x, front, back):
        if n == 0 or not less(x, back):
            if census is not None:
                census["back" if n else "empty"] += 1
            q[ring_at(h, n)] = x
            return h
        if less(x, front):
            if census is not None:
                census["front"] += 1
            h = N - 1 if h == 0 else h - 1
            q[h] = x
            return h
        if census is not None:
            census["walked"] += 1
        j, y = n - 1, back
        while True:
            if census is not None:
                census["steps"] += 1
            q[ring_at(h, j + 1)] = y
            j -= 1
            y = q[ring_at(h, j)]
            if not less(x, y):
                break
        q[ring_at(h, j + 1)] = x
        return h

    def ends(c):
        """(h, n, front, second, back) of core c's runqueue."""
        h, n, q = rqh[c], rqn[c], rq[c]
        front = q[h] if n > 0 else None
        back = q[ring_at(h, n - 1)] if n > 0 else None
        second = q[ring_at(h, 1)] if n > 1 else None
        return h, n, front, second, back

    def start_chunk(c, k, t, lim):
        cx = 0.0 if last[c] == k else CTX_SWITCH_MS
        if math.isnan(fr[k]):
            fr[k] = t
        run = py_max(py_min(rem[k], lim), EPS)
        cur[c], clen[c], end[c] = k, run, (t + cx) + run
        if cx > 0.0:
            nctx[k] += 1

    def cfs_pick(c, t):
        n = rqn[c] - 1
        if n < 0:
            return
        h = rqh[c]
        head = rq[c][h]
        rqh[c] = ring_at(h, 1)
        rqn[c] = n
        minvr[c] = py_max(minvr[c], head[0])
        start_chunk(c, head[2], t, slices[min(n, K)])

    def enqueue(c, v, k, t, e):
        """rq_push, then pick_next if c is idle, fused."""
        h, n, front, second, back = e
        x = (v, seqc[c], k)
        seqc[c] += 1
        if cur[c] >= 0:
            rqh[c] = rq_insert(rq[c], h, n, x, front, back)
            rqn[c] = n + 1
            return
        pick = x
        if n > 0 and less(front, x):
            pick = front
            rqh[c] = rq_insert(rq[c], ring_at(h, 1), n - 1, x, second, back)
        elif census is not None:
            census["picked"] += 1
        minvr[c] = py_max(minvr[c], pick[0])
        start_chunk(c, pick[2], t, slices[min(n, K)])

    def run_core(c, t, refill):
        nonlocal rrc, done
        k, L = cur[c], clen[c]
        e = None if c < nf else ends(c)
        r2 = rem[k] - L
        fin = r2 <= EPS
        cpu[k] = cpu[k] + L
        last[c], cur[c], end[c] = k, -1, INF
        if fin:
            rem[k], comp[k] = 0.0, t
            done += 1
        else:
            rem[k] = r2
            npre[k] += 1
        if c < nf:
            if not fin:
                nmig[k] += 1
                tgt = nf + rrc % (ncfs if ncfs > 0 else 1)
                rrc += 1
                vr[k] = py_max(vr[k], minvr[tgt])
                enqueue(tgt, vr[k], k, t, ends(tgt))
            if refill >= 0:
                start_chunk(c, refill, t, budget)
        elif not fin:
            vr[k] = vr[k] + L
            enqueue(c, vr[k], k, t, e)
        else:
            cfs_pick(c, t)

    ncfs = C - nf
    budget = py_max(limit - 0.0, 0.01)
    ev = ptr = qh = rr = 0          # every lane's
    rrc = done = 0                  # lane 0's
    capped = False
    while True:
        ta = arr[ptr] if ptr < n else INF
        tc, cc = next_expiry(end, C)
        arrive = ptr < n and (cc < 0 or ta <= tc)
        if not arrive and cc < 0:
            break
        if ev >= cap:
            capped = True
            break
        ev += 1
        if arrive:
            k, t = ptr, ta
            ptr += 1
            if nf > 0:
                f = first_idle(cur, nf)
                if f >= 0:
                    start_chunk(f, qh, t, budget)
                    qh += 1
            else:
                s0, rr = rr, (rr + 1) % C
                best = least_loaded(cur, rqn, C, s0)
                vr[k] = py_max(vr[k], minvr[best])
                enqueue(best, vr[k], k, t, ends(best))
            continue
        refill = cc < nf and qh < ptr
        run_core(cc, tc, qh if refill else -1)
        if refill:
            qh += 1
    return dict(completion=comp, first_run=fr, cpu_time=cpu,
                preemptions=npre, ctx_switches=nctx, migrations=nmig,
                ok=not capped and done == n, n_events=ev)


def emulate(policy, n_cores, tasks, kw=None, census=None):
    arr, svc, n, nf, lim = pack([Cell(policy, n_cores, tasks, kw or {})],
                                _bucket(len(tasks)))
    cap = int(event_caps(torch.from_numpy(svc), torch.from_numpy(n))[0])
    return emulate_cell(arr[0].tolist(), svc[0].tolist(), int(n[0]),
                        int(nf[0]), float(lim[0]), n_cores, cap, census)


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


def assert_equal_to_plain(out, plain, b):
    """The emulated kernel's outputs for one cell against row b of the
    plain version's: every float bit for bit, every count, n_events."""
    assert out["n_events"] == int(plain["n_events"][b])
    assert out["ok"] and bool(plain["ok"][b])
    for k in ("completion", "first_run", "cpu_time"):
        got = np.array(out[k])
        assert np.array_equal(got.view(np.int64),
                              plain[k][b].numpy().view(np.int64)), k
    for k in ("preemptions", "ctx_switches", "migrations"):
        assert out[k] == plain[k][b].tolist(), k


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
        assert_equal_to_plain(emulate(policy, 4, tasks, kw), plain, b)


def check_hand_made(policy, n_cores, specs, kw):
    """A task list of (arrival, service) pairs through the scalar engine,
    the emulated kernel and the plain version: all three equal."""
    raw = repro.run(Scenario(
        workload=WorkloadSpec(kind="tasks", tasks=mk_tasks(specs)),
        fleet=FleetSpec(cores_per_node=n_cores),
        policy=PolicySpec(name=policy, kw=kw))).raw
    tasks = [Task(tid=i, arrival=a, service=s)
             for i, (a, s) in enumerate(specs)]
    out = emulate(policy, n_cores, tasks, kw)
    assert out["ok"]
    assert as_digest(out, len(tasks)) == scalar_digest(raw)
    arrays = pack([Cell(policy, n_cores, tasks, kw)], _bucket(len(tasks)))
    assert_equal_to_plain(out, run_grid_plain(
        *map(torch.from_numpy, arrays), n_cores=n_cores), 0)


def lane_specs(n_cores):
    """The 600-a-minute trace's first 20 s in 5 s bursts (~47 tasks a
    burst): at 31-33 cores the queues grow, at 64-65 a burst leaves
    cores idle and its equal services expire together; one core gets
    the smoke trace's tasks in bursts."""
    spec = dict(SMOKE, seed=0) if n_cores == 1 else BIG
    return [(5000.0 * (t.arrival // 5000.0), t.service)
            for t in generate_workload(PortTraceSpec(**spec)).tasks
            if t.arrival < 20000.0]


BIG = dict(minutes=1, invocations_per_min=600.0, n_functions=40, seed=0)
LANE_CASES = [(p, c) for c in (1, 31, 32, 33, 64, 65)
              for p in ("fifo", "cfs", "hybrid") if c > 1 or p != "hybrid"]


@pytest.mark.parametrize("policy, n_cores", LANE_CASES,
                         ids=[f"{p}-{c}" for p, c in LANE_CASES])
def test_kernel_design_at_lane_boundaries(policy, n_cores):
    """Core counts on the warp's edges: one core (31 lanes hold none), 31
    and 32 (one round), 33 (a second round of one core), 64 and 65 (lane
    0 owns two and three cores)."""
    check_hand_made(policy, n_cores, lane_specs(n_cores), {})


def tie_specs(n_cores):
    """Forced ties. A burst of C + 3 tasks of one service at 0: the cores
    that hold one task each expire at one instant (the lowest cid first),
    and a CFS arrival past the first C sees every core busy with equal
    nr (the rotating start wins). A task arrives exactly at that expiry
    ((0 + ctx) + 5, the same float), so the arrival goes first. A gap
    leaves every core idle at once; then C long tasks fill the cores and
    three more arrive, again onto busy cores of equal nr."""
    burst = [(0.0, 5.0)] * (n_cores + 3)
    at_expiry = [((0.0 + CTX_SWITCH_MS) + 5.0, 1.0)]
    refill = [(1000.0, 400.0)] * n_cores
    return burst + at_expiry + refill + [(1000.5, 2.0), (1000.5, 3.0),
                                         (1001.0, 1.0)]


TIE_CASES = [(p, c, kw) for c in (4, 33, 65)
             for p, kw in (("fifo", {}), ("cfs", {}), ("hybrid", {}),
                           ("hybrid", {"time_limit_ms": 2.5}))]


@pytest.mark.parametrize(
    "policy, n_cores, kw", TIE_CASES,
    ids=[f"{p}{'-limit=2.5' if kw else ''}-{c}" for p, c, kw in TIE_CASES])
def test_kernel_design_on_forced_ties(policy, n_cores, kw):
    check_hand_made(policy, n_cores, tie_specs(n_cores), kw)


CROWD = [(name, cell) for name, cell in long_queue_cells()
         if name.startswith("crowd")]


@pytest.mark.parametrize("name, cell", CROWD, ids=[n for n, _ in CROWD])
def test_kernel_design_on_long_queues(name, cell):
    """mc_time's crowd cells, 2000 tasks at once on 50 cores: runqueues
    of 40-80 under cfs, and under the hybrid (1 ms limit) migrations
    that mostly walk into the middle of their ring."""
    check_hand_made(cell.policy, cell.n_cores,
                    [(t.arrival, t.service) for t in cell.tasks], cell.kw)


def test_warp_reductions_match_the_scalar_scans():
    """The three reductions against the scalar kernel's scans on random
    states, ties and all-idle included, at C across the lane edges."""
    rng = np.random.default_rng(0)
    for C in (1, 2, 31, 32, 33, 63, 64, 65, 97):
        for _ in range(40):
            end = [INF if rng.random() < 0.3 else float(rng.integers(-3, 4))
                   for _ in range(C)]
            if rng.random() < 0.1:
                end = [INF] * C
            cc, tc = -1, INF
            for c in range(C):
                if end[c] < tc:
                    tc, cc = end[c], c
            assert next_expiry(end, C) == (tc, cc)
            cur = [-1 if rng.random() < 0.2 else 0 for _ in range(C)]
            rqn = [int(rng.integers(0, 3)) for _ in range(C)]
            nf = int(rng.integers(0, C + 1))
            want = next((c for c in range(nf) if cur[c] < 0), -1)
            assert first_idle(cur, nf) == want
            s0 = int(rng.integers(0, C))
            best, best_nr = -1, 0
            for i in range(C):
                c = (s0 + i) % C
                nr = rqn[c] + (1 if cur[c] >= 0 else 0)
                if nr == 0:
                    best = c
                    break
                if best < 0 or nr < best_nr:
                    best, best_nr = c, nr
            assert least_loaded(cur, rqn, C, s0) == best


@pytest.mark.parametrize("policy", pd.POLICIES)
def test_paper_digests_match_scalar_engine_at_seed_0(policy):
    """paper_digests.py's seed-0 rows, recomputed from the scalar engine
    (the cfs cell takes ~6 s)."""
    assert scalar_paper_digests([0], [policy]) == \
        {(policy, 0): pd.DIGESTS[policy, 0]}
    assert set(pd.DIGESTS) == {(p, s) for p in pd.POLICIES
                               for s in pd.SEEDS}


def test_push_census_counts_every_push():
    """Under cfs every arrival and every preemption pushes once: the
    census's kinds add up to n + sum(preemptions), and a walk moves at
    least one slot. Arrivals in bursts onto 2 cores show every kind."""
    from collections import Counter
    tasks = [Task(tid=x.tid, arrival=500.0 * (x.arrival // 500.0),
                  service=x.service)
             for x in generate_workload(PortTraceSpec(**SMOKE, seed=0)).tasks]
    census = Counter()
    out = emulate("cfs", 2, tasks, census=census)
    assert out["ok"]
    kinds = ("empty", "back", "front", "walked", "picked")
    assert sum(census[k] for k in kinds) == \
        len(tasks) + sum(out["preemptions"])
    assert all(census[k] > 0 for k in kinds)
    assert census["steps"] >= census["walked"]


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
