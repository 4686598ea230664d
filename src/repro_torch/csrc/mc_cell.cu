// mc_cell: one cell of the batched Monte-Carlo engine a block. A cell is
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
// runqueue it pushes to), so a cell is one thread walking ~3 M events (a
// CFS cell of the paper's trace) at memory latency; the bytes of the
// inputs and outputs (the reported bound) take microseconds.
//
// Design:
// - One thread a block, one block a cell. Per-core state (in-flight task,
//   expiry, chunk length, last task, min_vruntime, push counter, queue
//   length) lives in dynamic shared memory, 40 bytes a core, beside the
//   slice table.
// - Events in the scalar heap's order (time, class, tie): the next core
//   expiry is the (end, cid) minimum over the cores, and a pending arrival
//   at or before it comes first (arrivals are class 0).
// - Each core's CFS runqueue is a binary min-heap keyed (vruntime, seq) in
//   global memory (capacity N), the scalar Core.rq_push / rq_pop: a pick is
//   O(log queue), not a scan of the N task slots as in the JAX kernel.
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

struct Params {
  const double* arrival;     // (B, N)
  const int* n_tasks;        // (B,)
  const int* n_fifo;         // (B,)
  const double* limit;       // (B,)
  const int64_t* max_events; // (B,)
  double* rem;               // (B, N) in: service
  double* vr;                // (B, N) in: 0
  double* heap_v;            // (B, C, N) runqueue keys: vruntime
  int* heap_seq;             // (B, C, N) runqueue keys: push counter
  int* heap_tid;             // (B, C, N) runqueue entries
  double* completion;        // (B, N) in: NaN
  double* first_run;         // (B, N) in: NaN
  double* cpu_time;          // (B, N) in: 0
  int* preemptions;          // (B, N) in: 0
  int* ctx_switches;         // (B, N) in: 0
  int* migrations;           // (B, N) in: 0
  uint8_t* ok;               // (B,)
  int64_t* n_events;         // (B,)
  const double* slices;      // (K + 1,) cfs_slice_ms(nr) for nr = 0..K
  int K, C, N;
  double ctx;
};

// One cell's state: per-task arrays in global memory, per-core in shared.
struct Cell {
  double *rem, *vr, *cpu, *fr, *comp;
  int *npre, *nctx, *nmig;
  double* hv;
  int *hs, *ht;
  double *end, *clen, *minvr, *slices;
  int *cur, *last, *seqc, *rqn;
  int K, N;
  double ctx;
};

__device__ __forceinline__ bool key_less(double v, int s, double pv, int ps) {
  return v < pv || (v == pv && s < ps);
}

// Core.rq_push: insert (v, s) -> k into core c's heap.
__device__ void rq_push(Cell& st, int c, double v, int s, int k) {
  double* hv = st.hv + static_cast<size_t>(c) * st.N;
  int* hs = st.hs + static_cast<size_t>(c) * st.N;
  int* ht = st.ht + static_cast<size_t>(c) * st.N;
  int i = st.rqn[c]++;
  while (i > 0) {
    const int p = (i - 1) >> 1;
    const double pv = hv[p];
    const int ps = hs[p];
    if (!key_less(v, s, pv, ps)) break;
    hv[i] = pv;
    hs[i] = ps;
    ht[i] = ht[p];
    i = p;
  }
  hv[i] = v;
  hs[i] = s;
  ht[i] = k;
}

// Core.rq_pop without the min_vruntime ratchet: the least (vruntime, seq).
__device__ void rq_pop(Cell& st, int c, double& v, int& k) {
  double* hv = st.hv + static_cast<size_t>(c) * st.N;
  int* hs = st.hs + static_cast<size_t>(c) * st.N;
  int* ht = st.ht + static_cast<size_t>(c) * st.N;
  v = hv[0];
  k = ht[0];
  const int n = --st.rqn[c];
  if (n == 0) return;
  const double lv = hv[n];
  const int ls = hs[n], lt = ht[n];
  int i = 0;
  for (;;) {
    const int l = 2 * i + 1;
    if (l >= n) break;
    int m = l;
    double mv = hv[l];
    int ms = hs[l];
    if (l + 1 < n && key_less(hv[l + 1], hs[l + 1], mv, ms)) {
      m = l + 1;
      mv = hv[m];
      ms = hs[m];
    }
    if (!key_less(mv, ms, lv, ls)) break;
    hv[i] = mv;
    hs[i] = ms;
    ht[i] = ht[m];
    i = m;
  }
  hv[i] = lv;
  hs[i] = ls;
  ht[i] = lt;
}

// Scheduler._start_chunk: install task k on core c at t under `lim`.
__device__ void start_chunk(Cell& st, int c, int k, double t, double lim) {
  const double cx = st.last[c] == k ? 0.0 : st.ctx;
  if (isnan(st.fr[k])) st.fr[k] = t;
  const double run = chunk_run(st.rem[k], lim);
  st.cur[c] = k;
  st.clen[c] = run;
  st.end[c] = chunk_end(t, cx, run);
  if (cx > 0.0) st.nctx[k] += 1;
}

// CFS pick_next + _start_chunk on an idle core: the slice reads the queue
// length after the pop (the core holds no task yet).
__device__ void cfs_pick(Cell& st, int c, double t) {
  if (st.rqn[c] == 0) return;
  double v;
  int k;
  rq_pop(st, c, v, k);
  st.minvr[c] = py_max(st.minvr[c], v);
  const int nr = st.rqn[c];
  start_chunk(st, c, k, t, st.slices[nr < st.K ? nr : st.K]);
}

__global__ void __launch_bounds__(1) mc_cell_kernel(Params p) {
  extern __shared__ double smem[];
  const int b = blockIdx.x;
  const int C = p.C, N = p.N;
  const size_t off = static_cast<size_t>(b) * N;
  const size_t hoff = static_cast<size_t>(b) * C * N;
  Cell st;
  st.rem = p.rem + off;
  st.vr = p.vr + off;
  st.cpu = p.cpu_time + off;
  st.fr = p.first_run + off;
  st.comp = p.completion + off;
  st.npre = p.preemptions + off;
  st.nctx = p.ctx_switches + off;
  st.nmig = p.migrations + off;
  st.hv = p.heap_v + hoff;
  st.hs = p.heap_seq + hoff;
  st.ht = p.heap_tid + hoff;
  st.end = smem;
  st.clen = smem + C;
  st.minvr = smem + 2 * C;
  st.slices = smem + 3 * C;
  int* ints = reinterpret_cast<int*>(smem + 3 * C + p.K + 1);
  st.cur = ints;
  st.last = ints + C;
  st.seqc = ints + 2 * C;
  st.rqn = ints + 3 * C;
  st.K = p.K;
  st.N = N;
  st.ctx = p.ctx;
  for (int i = 0; i <= p.K; ++i) st.slices[i] = p.slices[i];
  for (int c = 0; c < C; ++c) {
    st.end[c] = CUDART_INF;
    st.clen[c] = 0.0;
    st.minvr[c] = 0.0;
    st.cur[c] = -1;
    st.last[c] = -1;
    st.seqc[c] = 0;
    st.rqn[c] = 0;
  }

  const double* arr = p.arrival + off;
  const int n = p.n_tasks[b];
  const int nf = p.n_fifo[b];        // C: plain FIFO, 0: pure CFS
  const int ncfs = C - nf;
  // fifo_budget_ms(limit, cpu_time): the global queue holds fresh tasks
  const double budget = py_max(p.limit[b] - 0.0, 0.01);
  const int64_t cap = p.max_events[b];
  int64_t ev = 0;
  int ptr = 0, qh = 0, rr = 0, rrc = 0, done = 0;
  bool capped = false;

  for (;;) {
    // the next core expiry: least (end, cid); idle cores hold +inf
    int cc = -1;
    double tc = CUDART_INF;
    for (int c = 0; c < C; ++c) {
      const double e = st.end[c];
      if (e < tc) {
        tc = e;
        cc = c;
      }
    }
    const bool arrive = ptr < n && (cc < 0 || arr[ptr] <= tc);
    if (!arrive && cc < 0) break;
    if (ev >= cap) {
      capped = true;
      break;
    }
    ++ev;

    if (arrive) {
      const int k = ptr++;
      const double t = arr[k];
      if (nf > 0) {
        // hybrid / FIFO: k joins the global queue; the first idle FIFO
        // core (cid order) takes the queue's head
        for (int c = 0; c < nf; ++c) {
          if (st.cur[c] < 0) {
            start_chunk(st, c, qh++, t, budget);
            break;
          }
        }
      } else {
        // CFS._least_loaded: scan from the rotating start, first idle
        // core wins, else the first with the fewest runnable
        const int s0 = rr;
        rr = (rr + 1) % C;
        int best = -1, best_nr = 0;
        for (int i = 0; i < C; ++i) {
          int c = s0 + i;
          if (c >= C) c -= C;
          const int nr = st.rqn[c] + (st.cur[c] >= 0 ? 1 : 0);
          if (nr == 0) {
            best = c;
            break;
          }
          if (best < 0 || nr < best_nr) {
            best = c;
            best_nr = nr;
          }
        }
        const double v = py_max(st.vr[k], st.minvr[best]);
        st.vr[k] = v;
        rq_push(st, best, v, st.seqc[best]++, k);
        if (st.cur[best] < 0) cfs_pick(st, best, t);
      }
      continue;
    }

    // Scheduler._run_core: expire core cc's chunk at tc
    const int c = cc;
    const double t = tc;
    const int k = st.cur[c];
    const double L = st.clen[c];
    const double r2 = st.rem[k] - L;
    st.cpu[k] = st.cpu[k] + L;
    st.last[c] = k;
    st.cur[c] = -1;
    st.end[c] = CUDART_INF;
    if (r2 <= kEps) {  // events.py chunk_completes
      st.rem[k] = 0.0;
      st.comp[k] = t;
      ++done;
    } else {
      st.rem[k] = r2;
      if (c < nf) {
        // hybrid time limit: preempt, migrate round robin onto CFS
        st.npre[k] += 1;
        st.nmig[k] += 1;
        const int tgt = nf + rrc % (ncfs > 0 ? ncfs : 1);
        ++rrc;
        const double v = py_max(st.vr[k], st.minvr[tgt]);
        st.vr[k] = v;
        rq_push(st, tgt, v, st.seqc[tgt]++, k);
        if (st.cur[tgt] < 0) cfs_pick(st, tgt, t);
      } else {
        // CFS slice expiry: charge vruntime, back onto this core's queue
        const double v = st.vr[k] + L;
        st.vr[k] = v;
        st.npre[k] += 1;
        rq_push(st, c, v, st.seqc[c]++, k);
      }
    }
    if (c < nf) {
      if (qh < ptr) start_chunk(st, c, qh++, t, budget);
    } else {
      cfs_pick(st, c, t);
    }
  }
  p.ok[b] = (!capped && done == n) ? 1 : 0;
  p.n_events[b] = ev;
}

}  // namespace
}  // namespace repro

// All pointers on the current device, contiguous; the per-task outputs and
// rem / vr initialised by the wrapper (see Params). Returns a cudaError_t.
extern "C" int repro_mc_cell(
    const void* arrival, const void* n_tasks, const void* n_fifo,
    const void* limit, const void* max_events, void* rem, void* vr,
    void* heap_v, void* heap_seq, void* heap_tid, void* completion,
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
  p.heap_v = static_cast<double*>(heap_v);
  p.heap_seq = static_cast<int*>(heap_seq);
  p.heap_tid = static_cast<int*>(heap_tid);
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
  p.C = C;
  p.N = N;
  p.ctx = ctx;
  const size_t smem = (3 * static_cast<size_t>(C) + K + 1) * sizeof(double) +
                      4 * static_cast<size_t>(C) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        repro::mc_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  repro::mc_cell_kernel<<<B, 1, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
