// mc_cell: one cell of the batched Monte-Carlo engine a warp. A cell is
// one (policy, trace) trajectory of the single-node scheduler in the
// supported regime: fifo, cfs or hybrid with a static time limit, the
// default Linux knobs, no container pool. Every cell runs its event loop
// to the end; the outputs are bit-identical to the scalar engine's
// (repro.core.events + policies + hybrid) per-task observables.
//
// Replaces the jitted vmap(lax.while_loop) program of the JAX package,
// make_cell_kernel (src/repro/mc/kernels.py:112), run by run_grid (:762).
// On a TPU that program carried no bit-level promise; here every float is
// an IEEE f64 add, subtract or compare in the order the scalar engine
// evaluates it (its regime helpers, src/repro/core/events.py:80-115, are
// the inline functions below), built with -fmad=false so that no
// product-and-add is contracted. The one division of the regime, the CFS
// slice sched_latency / nr_running, depends on the queue length alone: the
// wrapper passes cfs_slice_ms for nr = 0..K (the least K whose slice is the
// granularity, which every longer queue gets too), so the kernel divides
// nothing and its SASS holds no DFMA (an f64 division is a DFMA sequence).
//
// Bound on an H100: a dependent chain. Each event reads the state the
// previous one wrote (the core to expire next, the task it ran, the
// runqueue it pushes to), so a cell walks its ~3 M events (a CFS cell of
// the paper's trace) one after the other at instruction and memory
// latency, one warp alone on its SM; the bytes of the inputs and outputs
// (the reported bound) take microseconds. A CFS event is the scan for the
// next expiry, the expiring task's fields and the ends of its core's
// runqueue (one trip to L2), an insert at an end of the queue and the
// picked task's fields (another trip).
//
// Design:
// - One warp a cell, several cells a block (one warp each, so that a
//   sweep of hundreds of cells fills the card's SMs; see the launch).
//   Lane l owns cores l, l + 32, ...: the scans over the cores are warp
//   reductions, one shared-memory load a core a lane and five shuffle
//   rounds, in place of C dependent compares on one thread.
// - Per-core state (in-flight task, expiry, chunk length, last task,
//   min_vruntime, push counter, queue head and length) lives in the
//   warp's slice of dynamic shared memory, 44 bytes a core, beside its
//   copy of the slice table. Lane 0 runs the serial rest and writes it;
//   every lane reloads its own cores at the next scan (one shared load,
//   where registers would need each write broadcast to the core's owner).
// - Events in the scalar heap's order (time, class, tie): the next core
//   expiry is the (end, cid) minimum over the cores, and a pending arrival
//   at or before it comes first (arrivals are class 0). The reductions
//   only compare, so they are exact in any order: min, first-set and
//   lexicographic minima give the scalar scans' answers, ties included.
// - Each core's CFS runqueue is a run of slots sorted by (vruntime, seq)
//   in a ring of capacity N in global memory, the scalar Core.rq_push's
//   insort and rq_pop's pop(0): the front is the pick. A task back from
//   its slice has the largest vruntime and joins at the back; a task at
//   the queue's min_vruntime (an arrival, a migration) joins at the
//   front; nearly every push of the paper's CFS cell is at an end, the
//   rest walk in from the back. A push that the core's pick follows at once
//   (a slice expiry, a migration or an arrival onto an idle core) picks
//   the lesser of the front and the pushed task (keys are unique: seq
//   counts pushes), and the pushed task joins only if the front was less.
// - The hybrid / FIFO global queue holds only fresh tasks, in arrival
//   order, so it is the tid range [qh, ptr) of two counters.
// - A cap on events (the wrapper's event_caps) ends a cell that would run
//   on; ok is then 0, as it is for a cell that leaves a live task
//   unfinished.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {
namespace {

constexpr double kEps = 1e-9;  // repro/core/events.py _EPS
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;   // cells a block at most

// Python's min(a, b) and max(a, b): a unless b is strictly smaller
// (larger) -- the operand order the scalar engine's helpers use.
__device__ __forceinline__ double py_min(double a, double b) {
  return b < a ? b : a;
}
__device__ __forceinline__ double py_max(double a, double b) {
  return b > a ? b : a;
}
// events.py chunk_run_ms(remaining, limit)
__device__ __forceinline__ double chunk_run(double rem, double lim) {
  return py_max(py_min(rem, lim), kEps);
}
// events.py chunk_end_ms: (t + ctx) + run, left-associated
__device__ __forceinline__ double chunk_end(double t, double ctx, double run) {
  return (t + ctx) + run;
}

// A runqueue slot: the key (vruntime, push counter) and the task, 16
// bytes.
struct __align__(16) Slot {
  double v;
  int s, k;
};

struct Params {
  const double* arrival;     // (B, N)
  const int* n_tasks;        // (B,)
  const int* n_fifo;         // (B,)
  const double* limit;       // (B,)
  const int64_t* max_events; // (B,)
  double* rem;               // (B, N) in: service
  double* vr;                // (B, N) in: 0
  Slot* rq;                  // (B, C, N) runqueue slots, a ring a core
  double* completion;        // (B, N) in: NaN
  double* first_run;         // (B, N) in: NaN
  double* cpu_time;          // (B, N) in: 0
  int* preemptions;          // (B, N) in: 0
  int* ctx_switches;         // (B, N) in: 0
  int* migrations;           // (B, N) in: 0
  uint8_t* ok;               // (B,)
  int64_t* n_events;         // (B,)
  const double* slices;      // (K + 1,) cfs_slice_ms(nr) for nr = 0..K
  int K, B, C, N;
  double ctx;
};

// One cell's state: per-task arrays in global memory, per-core in the
// warp's slice of shared memory.
struct Cell {
  double *rem, *vr, *cpu, *fr, *comp;
  int *npre, *nctx, *nmig;
  Slot* rq;  // core c's runqueue: rq[c * N + (rqh[c] + j) mod N], j < rqn[c]
  double *end, *clen, *minvr, *slices;
  int *cur, *last, *seqc, *rqn, *rqh;
  int K, N;
  double ctx;
};

__device__ __forceinline__ bool key_less(double v, int s, double pv, int ps) {
  // vruntimes are >= +0, whose bit patterns order as their values
  const long long a = __double_as_longlong(v), b = __double_as_longlong(pv);
  const bool lt = a < b, eq = a == b, sl = s < ps;
  return lt | (eq & sl);
}

// Position j of a ring of N slots whose front is at h.
__device__ __forceinline__ int ring_at(int h, int j, int N) {
  const int i = h + j;
  return i < N ? i : i - N;
}

// Core.rq_push's insort: x joins the sorted run of n slots at h of ring q
// (the least key in front), appended past the back (a task back from its
// slice, nearly every push), prepended before the front (a task at the
// queue's min_vruntime: an arrival, a migration), else walked in from the
// back. front and back are the run's ends (n > 0). Returns the new head.
__device__ __forceinline__ int rq_insert(Slot* q, int N, int h, int n,
                                         const Slot& x, const Slot& front,
                                         const Slot& back) {
  if (n == 0 || !key_less(x.v, x.s, back.v, back.s)) {
    q[ring_at(h, n, N)] = x;
    return h;
  }
  if (key_less(x.v, x.s, front.v, front.s)) {
    h = h == 0 ? N - 1 : h - 1;
    q[h] = x;
    return h;
  }
  int j = n - 1;
  Slot y = back;
  do {
    q[ring_at(h, j + 1, N)] = y;
    --j;
    y = q[ring_at(h, j, N)];
  } while (key_less(x.v, x.s, y.v, y.s));
  q[ring_at(h, j + 1, N)] = x;
  return h;
}

// The ends of core c's runqueue, loaded together: its front, the slot
// behind it and its back (those that exist).
struct Ends {
  int h, n;
  Slot front, second, back;
};

__device__ __forceinline__ Ends ends(const Cell& st, int c) {
  Ends e;
  e.h = st.rqh[c];
  e.n = st.rqn[c];
  const Slot* q = st.rq + static_cast<size_t>(c) * st.N;
  if (e.n > 0) {
    e.front = q[e.h];
    e.back = q[ring_at(e.h, e.n - 1, st.N)];
  }
  if (e.n > 1) e.second = q[ring_at(e.h, 1, st.N)];
  return e;
}

// Scheduler._start_chunk: install task k on core c at t under `lim`. The
// task's fields are read together, before any write, so that their loads
// share one trip to memory.
__device__ __forceinline__ void start_chunk(Cell& st, int c, int k, double t,
                                            double lim) {
  const double fr = st.fr[k], rem = st.rem[k];
  const int nctx = st.nctx[k];
  const double cx = st.last[c] == k ? 0.0 : st.ctx;
  if (isnan(fr)) st.fr[k] = t;
  const double run = chunk_run(rem, lim);
  st.cur[c] = k;
  st.clen[c] = run;
  st.end[c] = chunk_end(t, cx, run);
  if (cx > 0.0) st.nctx[k] = nctx + 1;
}

// CFS pick_next + _start_chunk on an idle core: pop the least (vruntime,
// seq), the queue's front (Core.rq_pop, whose min_vruntime ratchet
// follows); the slice reads the queue length after the pop (the core
// holds no task yet).
__device__ __forceinline__ void cfs_pick(Cell& st, int c, double t) {
  const int n = st.rqn[c] - 1;
  if (n < 0) return;
  const int h = st.rqh[c];
  const Slot head = st.rq[static_cast<size_t>(c) * st.N + h];
  st.rqh[c] = ring_at(h, 1, st.N);
  st.rqn[c] = n;
  st.minvr[c] = py_max(st.minvr[c], head.v);
  start_chunk(st, c, head.k, t, st.slices[n < st.K ? n : st.K]);
}

// Core.rq_push of task k at vruntime v onto core c, whose runqueue's ends
// are e, then, if c is idle, its pick_next. Push and pop fuse: the least
// of the front and (v, seq) is picked (keys are unique: seq counts
// pushes), and (v, seq) joins the queue only if the front was less.
__device__ __forceinline__ void enqueue(Cell& st, int c, double v, int k,
                                        double t, const Ends& e) {
  const Slot x{v, st.seqc[c]++, k};
  Slot* q = st.rq + static_cast<size_t>(c) * st.N;
  if (st.cur[c] >= 0) {
    st.rqh[c] = rq_insert(q, st.N, e.h, e.n, x, e.front, e.back);
    st.rqn[c] = e.n + 1;
    return;
  }
  Slot pick = x;
  if (e.n > 0 && key_less(e.front.v, e.front.s, v, x.s)) {
    pick = e.front;
    st.rqh[c] = rq_insert(q, st.N, ring_at(e.h, 1, st.N), e.n - 1, x,
                          e.second, e.back);
  }
  st.minvr[c] = py_max(st.minvr[c], pick.v);
  start_chunk(st, c, pick.k, t, st.slices[e.n < st.K ? e.n : st.K]);
}

// Bytes of shared memory a cell takes: end, clen, minvr (C doubles
// each), the slice table (K + 1 doubles), cur, last, seqc, rqn, rqh (C
// ints each); a multiple of 16.
__host__ __device__ __forceinline__ size_t cell_bytes(int C, int K) {
  const size_t b = 8 * (3 * static_cast<size_t>(C) + K + 1) +
                   4 * 5 * static_cast<size_t>(C);
  return (b + 15) / 16 * 16;
}

// The next core expiry, the scalar scan's least end under a strict `<`
// (lowest cid on a tie): each lane takes the least (end, cid) of its own
// cores, then a shuffle-xor tree leaves the least over all lanes in every
// lane. Compares only. cc = -1 when every core holds +inf (idle).
__device__ __forceinline__ void next_expiry(const double* end, int C,
                                            int lane, double& tc, int& cc) {
  double e = CUDART_INF;
  int i = C;
  for (int c = lane; c < C; c += 32) {
    const double x = end[c];
    if (x < e) {
      e = x;
      i = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double oe = __shfl_xor_sync(kFull, e, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    const bool lt = oe < e, eq = oe == e, il = oi < i;
    if (lt | (eq & il)) {
      e = oe;
      i = oi;
    }
  }
  tc = e;
  cc = e < CUDART_INF ? i : -1;
}

// The first idle FIFO core in cid order (-1 if none): a ballot a round of
// 32 cores, the lowest set bit of the first round that has one.
__device__ __forceinline__ int first_idle(const int* cur, int nf, int lane) {
  for (int base = 0; base < nf; base += 32) {
    const int c = base + lane;
    const unsigned m = __ballot_sync(kFull, c < nf && cur[c] < 0);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// CFS._least_loaded from the rotating start s0: the scalar scan takes the
// first idle core in rotated order, else the first with the fewest
// runnable. An idle core is one with nr = 0, the least nr, so both are the
// least (nr, r) with r = (c - s0) mod C: a lane's own least, then two
// integer minima over the warp (nr, then r among the lanes holding it).
__device__ __forceinline__ int least_loaded(const int* cur, const int* rqn,
                                            int C, int s0, int lane) {
  unsigned bn = 0xffffffffu, br = 0xffffffffu;
  for (int c = lane; c < C; c += 32) {
    const unsigned nr = rqn[c] + (cur[c] >= 0 ? 1 : 0);
    const unsigned r = c >= s0 ? c - s0 : c - s0 + C;
    if (nr < bn || (nr == bn && r < br)) {
      bn = nr;
      br = r;
    }
  }
  const unsigned mn = __reduce_min_sync(kFull, bn);
  const unsigned mr = __reduce_min_sync(kFull, bn == mn ? br : 0xffffffffu);
  const int best = s0 + static_cast<int>(mr);
  return best < C ? best : best - C;
}

// Scheduler._run_core: expire core c's chunk at t. `refill` is the global
// queue's head for a FIFO core to take next, or -1. Task k's fields are
// read together, before any write.
__device__ __forceinline__ void run_core(Cell& st, int c, double t, int nf,
                                         int ncfs, int refill, double budget,
                                         int& rrc, int& done) {
  const int k = st.cur[c];
  const double L = st.clen[c];
  // a CFS core's runqueue ends load beside the task's fields
  const Ends e = c < nf ? Ends{} : ends(st, c);
  const double rem = st.rem[k], cpu = st.cpu[k], vr = st.vr[k];
  const int npre = st.npre[k], nmig = c < nf ? st.nmig[k] : 0;
  const double r2 = rem - L;
  const bool fin = r2 <= kEps;  // events.py chunk_completes
  st.cpu[k] = cpu + L;
  st.last[c] = k;
  st.cur[c] = -1;
  st.end[c] = CUDART_INF;
  if (fin) {
    st.rem[k] = 0.0;
    st.comp[k] = t;
    ++done;
  } else {
    st.rem[k] = r2;
    st.npre[k] = npre + 1;
  }
  if (c < nf) {
    if (!fin) {
      // hybrid time limit: preempt, migrate round robin onto CFS
      st.nmig[k] = nmig + 1;
      const int tgt = nf + rrc % (ncfs > 0 ? ncfs : 1);
      ++rrc;
      const double v = py_max(vr, st.minvr[tgt]);
      st.vr[k] = v;
      enqueue(st, tgt, v, k, t, ends(st, tgt));
    }
    if (refill >= 0) start_chunk(st, c, refill, t, budget);
  } else if (!fin) {
    // CFS slice expiry: charge vruntime, back onto this core's queue,
    // and the core picks
    const double v = vr + L;
    st.vr[k] = v;
    enqueue(st, c, v, k, t, e);
  } else {
    cfs_pick(st, c, t);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) mc_cell_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= p.B) return;  // the whole warp: no block barrier follows
  const int C = p.C, N = p.N;
  const size_t off = static_cast<size_t>(b) * N;
  const size_t qoff = static_cast<size_t>(b) * C * N;
  double* ws = reinterpret_cast<double*>(smem + wid * cell_bytes(C, p.K));
  Cell st;
  st.rem = p.rem + off;
  st.vr = p.vr + off;
  st.cpu = p.cpu_time + off;
  st.fr = p.first_run + off;
  st.comp = p.completion + off;
  st.npre = p.preemptions + off;
  st.nctx = p.ctx_switches + off;
  st.nmig = p.migrations + off;
  st.rq = p.rq + qoff;
  st.end = ws;
  st.clen = ws + C;
  st.minvr = ws + 2 * C;
  st.slices = ws + 3 * C;
  int* ints = reinterpret_cast<int*>(ws + 3 * C + p.K + 1);
  st.cur = ints;
  st.last = ints + C;
  st.seqc = ints + 2 * C;
  st.rqn = ints + 3 * C;
  st.rqh = ints + 4 * C;
  st.K = p.K;
  st.N = N;
  st.ctx = p.ctx;
  for (int i = lane; i <= p.K; i += 32) st.slices[i] = p.slices[i];
  for (int c = lane; c < C; c += 32) {
    st.end[c] = CUDART_INF;
    st.clen[c] = 0.0;
    st.minvr[c] = 0.0;
    st.cur[c] = -1;
    st.last[c] = -1;
    st.seqc[c] = 0;
    st.rqn[c] = 0;
    st.rqh[c] = 0;
  }

  const double* arr = p.arrival + off;
  const int n = p.n_tasks[b];
  const int nf = p.n_fifo[b];        // C: plain FIFO, 0: pure CFS
  const int ncfs = C - nf;
  // fifo_budget_ms(limit, cpu_time): the global queue holds fresh tasks
  const double budget = py_max(p.limit[b] - 0.0, 0.01);
  const int64_t cap = p.max_events[b];
  // every lane keeps the counters that steer the loop, so that each
  // branch is taken by the whole warp; lane 0 alone the rest
  int64_t ev = 0;
  int ptr = 0, qh = 0, rr = 0;
  int rrc = 0, done = 0;
  bool capped = false;

  for (;;) {
    __syncwarp();  // lane 0's writes of the last event are visible
    const double ta = ptr < n ? arr[ptr] : CUDART_INF;
    double tc;
    int cc;
    next_expiry(st.end, C, lane, tc, cc);
    const bool arrive = ptr < n && (cc < 0 || ta <= tc);
    if (!arrive && cc < 0) break;
    if (ev >= cap) {
      capped = true;
      break;
    }
    ++ev;

    if (arrive) {
      const int k = ptr++;
      const double t = ta;
      if (nf > 0) {
        // hybrid / FIFO: k joins the global queue; the first idle FIFO
        // core (cid order) takes the queue's head
        const int f = first_idle(st.cur, nf, lane);
        if (f >= 0) {
          if (lane == 0) start_chunk(st, f, qh, t, budget);
          ++qh;
        }
      } else {
        const int s0 = rr;
        rr = (rr + 1) % C;
        const int best = least_loaded(st.cur, st.rqn, C, s0, lane);
        if (lane == 0) {
          const double v = py_max(st.vr[k], st.minvr[best]);
          st.vr[k] = v;
          enqueue(st, best, v, k, t, ends(st, best));
        }
      }
      continue;
    }

    const bool refill = cc < nf && qh < ptr;
    if (lane == 0)
      run_core(st, cc, tc, nf, ncfs, refill ? qh : -1, budget, rrc, done);
    if (refill) ++qh;
  }
  if (lane == 0) {
    p.ok[b] = (!capped && done == n) ? 1 : 0;
    p.n_events[b] = ev;
  }
}

}  // namespace
}  // namespace repro

// All pointers on the current device, contiguous; the per-task outputs and
// rem / vr initialised by the wrapper (see Params). Returns a cudaError_t.
extern "C" int repro_mc_cell(
    const void* arrival, const void* n_tasks, const void* n_fifo,
    const void* limit, const void* max_events, void* rem, void* vr,
    void* rq, void* completion,
    void* first_run, void* cpu_time, void* preemptions, void* ctx_switches,
    void* migrations, void* ok, void* n_events, const void* slices, int K,
    int B, int C, int N, double ctx, void* stream) {
  if (B <= 0 || C <= 0 || N <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::Params p;
  p.arrival = static_cast<const double*>(arrival);
  p.n_tasks = static_cast<const int*>(n_tasks);
  p.n_fifo = static_cast<const int*>(n_fifo);
  p.limit = static_cast<const double*>(limit);
  p.max_events = static_cast<const int64_t*>(max_events);
  p.rem = static_cast<double*>(rem);
  p.vr = static_cast<double*>(vr);
  p.rq = static_cast<repro::Slot*>(rq);
  p.completion = static_cast<double*>(completion);
  p.first_run = static_cast<double*>(first_run);
  p.cpu_time = static_cast<double*>(cpu_time);
  p.preemptions = static_cast<int*>(preemptions);
  p.ctx_switches = static_cast<int*>(ctx_switches);
  p.migrations = static_cast<int*>(migrations);
  p.ok = static_cast<uint8_t*>(ok);
  p.n_events = static_cast<int64_t*>(n_events);
  p.slices = static_cast<const double*>(slices);
  p.K = K;
  p.B = B;
  p.C = C;
  p.N = N;
  p.ctx = ctx;
  // Cells a block: as many as it takes for the grid to cover every SM
  // once (one cell a block up to 132 cells on an H100), at most
  // kMaxWarps, and as many as fit the block's shared memory.
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t cell = repro::cell_bytes(C, K);
  if (cell > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);
  int w = (B + sms - 1) / sms;
  if (w > repro::kMaxWarps) w = repro::kMaxWarps;
  if (w > static_cast<int>(smem_max / cell))
    w = static_cast<int>(smem_max / cell);
  if (w < 1) w = 1;
  const size_t smem = w * cell;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(repro::mc_cell_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  repro::mc_cell_kernel<<<(B + w - 1) / w, 32 * w, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
