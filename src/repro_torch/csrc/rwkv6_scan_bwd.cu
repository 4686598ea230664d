// rwkv6_scan_bwd: the gradient of rwkv6_scan (csrc/rwkv6_scan.cu), the
// RWKV6 time-mix recurrence. Inputs: the forward's r, k, v, w (BH, S, hd)
// bf16 or f32 and u (NU, hd) f32 (row bh reads u row bh % NU); the
// gradients do (r's shape and dtype) of o and dS (BH, hd, hd) f32 of the
// final state (zeros when the caller drops the state, as training does).
// Writes dr, dk, dv, dw in r's dtype and du (NU, hd) f32, summed over the
// steps and over the heads that share a row of u.
//
// The gradient of the Pallas TPU kernel rwkv6_scan / _rwkv_kernel
// (src/repro/kernels/rwkv6_scan.py:46, body :17); the JAX package has no
// backward kernel and differentiates its jnp model with XLA. With S
// indexed [key i][value j], o_t = r_t (S_{t-1} + diag(u) k_t^T v_t) and
// S_t = diag(w_t) S_{t-1} + k_t^T v_t:
//   dS_{t-1} = diag(w_t) dS_t + r_t^T do_t              (dS_S = dS)
//   dr_t[i]  = sum_j S_{t-1}[i][j] do_t[j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i]  = sum_j dS_t[i][j] v_t[j] + r_t[i] u_i (v_t . do_t)
//   dv_t[j]  = sum_i dS_t[i][j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
//   dw_t[i]  = sum_j dS_t[i][j] S_{t-1}[i][j]
//   du_i     = sum_t r_t[i] k_t[i] (v_t . do_t).
// The rows i of S and dS are independent recurrences; only dv (and o)
// sum over i. Nothing divides by w, which may be exactly 0 or 1: every
// decay is a product of w's, and S_{t-1} is never recovered from S_t.
//
// Bound on an H100: the latency of the dependent chain of steps, which
// the first design walked 8,192 steps long (4,096 forward, 4,096 back)
// in each of 256 blocks. This one cuts it to chunks of kT = 64 steps,
// the forward's chunked product form (csrc/rwkv6_scan.cu) run in
// reverse, in three launches and the ordered sums:
// - rwkv6_bwd_sum_kernel, grid (BH, nc): a block a (head, chunk) forms
//   the chunk's decay g_c = prod_t w_t, what it adds to the state,
//   U_c = sum_t diag(b_t) k_t^T v_t with b_t the product of the w's after
//   t, and what it adds to the state's gradient across it, V_c =
//   sum_t diag(a_t) r_t^T do_t with a_t the product of the w's before t
//   (so S_end = diag(g_c) S_start + U_c and dS_{start-1} = diag(g_c)
//   dS_end + V_c), and v_t . do_t of each step; a thread a 4 x 4 tile of
//   U and of V, f32 FMAs.
// - rwkv6_bwd_carry_kernel, grid (BH, hd^2 / 256, 2): the only serial
//   part, over the nc chunks, elementwise on the (hd, hd) state: the
//   state at each chunk's start and its gradient at each chunk's end,
//   written over U_c and V_c.
// - rwkv6_bwd_chunk_kernel, grid (BH, nc, hd / RB): a block a head's RB
//   rows of the state (RB hd = 1024 entries; RB = hd at hd 16 and 32) in
//   one chunk, 256 threads, a thread CPT neighbouring columns of one row
//   (TPR threads a row). It steps the chunk's state forward from its
//   checkpoint, keeping it every kTs = 16 steps in shared memory, then
//   walks the sub-chunks in reverse: recomputes a sub-chunk's 16 states
//   into registers (forming dr), and carries dS back through them from
//   the chunk's end checkpoint, forming dk, dw (row sums through shared
//   memory once a sub-chunk) and dv (columns: across the rows of a warp
//   with shuffles, then across the warps in order), written as a partial
//   a row block. 3 kT = 192 dependent steps a block, not 8,192. The
//   sub-chunks' inputs stream by cp.async through two stages, the next
//   copied while one is computed.
// - sum_partials_kernel (common.cuh): dv over the row blocks, du over the
//   chunks and the heads of a u row, in order. No float atomics: two
//   calls give the same bits.
// Everything is f32 on the CUDA cores, the state held at the forward's
// 2e-5: PR 15's 3xTF32 forward did not pay, and the chain, not the FMAs,
// bounded the first design. kT = 64 keeps the checkpoints (U, V, then S
// and dS: 2 BH (S / 64) hd^2 f32, 134 MB at rwkv6's microbatch, written
// and read twice) at 0.16 ms of traffic, under the 0.195 ms operation
// bound; kT = 16 would be 537 MB. chip_smoke.py counts the flops
// (rwkv_bwd_flops: 12 hd^2 a step and head). Any S is taken.
// Measured there on an H100 80GB HBM3 (700 W): 2.27 ms (the first design
// 4.37 ms), 0.086 of the operation bound; in a train step a launch is
// 1.78 ms chunk pass + 0.26 summaries + 0.09 carry + 0.12 sums. By a
// count of the source, the chunk pass (16,384 blocks of 192 dependent
// steps) issues some 20 instructions an element and step (the forward,
// the recompute and the reverse over the state, the row and column
// reductions), which at the card's issue rate would take 0.7 ms: the
// per-step form, not the chain, is what bounds it now, and the chunked
// matrix form of the backward is the next lever (PERF.md, row 5b).
// tests/test_torch_scan_grad.py emulates this on the CPU.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;             // steps a chunk (between checkpoints)
constexpr int kTs = 16;            // steps a sub-chunk (states in registers)
constexpr int kSub = kT / kTs;
constexpr int kCarry = 8;          // chunks a carry thread loads at a time

// N neighbouring floats, by 16-byte accesses where N allows
template <int N>
__device__ __forceinline__ void load_n(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + m);
      x[m] = f.x;
      x[m + 1] = f.y;
      x[m + 2] = f.z;
      x[m + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) x[m] = p[m];
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4)
      *reinterpret_cast<float4*>(p + m) =
          make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) p[m] = x[m];
  }
}

// N neighbouring inputs as f32 (16-byte reads of f32, 8-byte of bf16)
template <int N>
__device__ __forceinline__ void load_in(float (&x)[N], const float* p) {
  load_n(x, p);
}
template <int N>
__device__ __forceinline__ void load_in(float (&x)[N],
                                        const __nv_bfloat16* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p + m);
      x[m] = __uint_as_float(w.x << 16);
      x[m + 1] = __uint_as_float(w.x & 0xffff0000u);
      x[m + 2] = __uint_as_float(w.y << 16);
      x[m + 3] = __uint_as_float(w.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) x[m] = __bfloat162float(p[m]);
  }
}

// -- the chunk summaries: g, U, V of a (head, chunk) -----------------------------

template <int HD>
struct SumLayout {
  static constexpr int kTI = HD / 16;   // a thread's rows and columns
  // floats: r~ (a_t r_t), k~ (b_t k_t), v, do, w, each [kT][HD]
  static constexpr int kBytes = 5 * kT * HD * 4;
};

template <typename Tin, int HD>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_sum_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                     const Tin* __restrict__ v, const Tin* __restrict__ w,
                     const Tin* __restrict__ dout, float* __restrict__ us,
                     float* __restrict__ vs, float* __restrict__ gs,
                     float* __restrict__ vdo, int S, int nc) {
  using L = SumLayout<HD>;
  constexpr int TI = L::kTI;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sr = reinterpret_cast<float*>(smem);
  float* sk = sr + kT * HD;
  float* sv = sk + kT * HD;
  float* sdo = sv + kT * HD;
  float* sw = sdo + kT * HD;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int t0 = c * kT, n = min(kT, S - t0);
  const size_t base = (static_cast<size_t>(bh) * S + t0) * HD;
  for (int e = 4 * tid; e < kT * HD; e += 4 * kThreads) {
    const bool in = e < n * HD;
    float* dst[5] = {sr, sk, sv, sdo, sw};
    const Tin* src[5] = {r, k, v, dout, w};
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (in) load_in(x, src[a] + base + e);
      store_n(dst[a] + e, x);
    }
  }
  __syncthreads();
  const size_t cs = static_cast<size_t>(bh) * nc + c;
  // v_t . do_t of the chunk's steps (0 past S), a warp a step, in order
  for (int t = tid / 32; t < kT; t += kThreads / 32) {
    float a = 0.f;
    for (int j = tid % 32; j < HD; j += 32)
      a = fmaf(sv[t * HD + j], sdo[t * HD + j], a);
    a = warp_sum(a);
    if (tid % 32 == 0) vdo[cs * kT + t] = a;
  }
  if (tid < HD) {                    // the decays of channel tid, as products
    float a = 1.f;
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      sr[t * HD + tid] *= a;         // a_t r_t
      a *= sw[t * HD + tid];
    }
    gs[cs * HD + tid] = a;           // g_c
    float b = 1.f;
#pragma unroll 8
    for (int t = n - 1; t >= 0; --t) {
      sk[t * HD + tid] *= b;         // b_t k_t
      b *= sw[t * HD + tid];
    }
  }
  __syncthreads();
  // U = k~^T v, V = r~^T do: a thread rows ty TI.., columns tx TI..
  const int ty = tid / 16, tx = tid % 16;
  float au[TI][TI], av[TI][TI];
#pragma unroll
  for (int a = 0; a < TI; ++a)
#pragma unroll
    for (int b = 0; b < TI; ++b) au[a][b] = av[a][b] = 0.f;
  for (int t = 0; t < n; ++t) {
    float ki[TI], ri[TI], vj[TI], dj[TI];
    load_n(ki, sk + t * HD + ty * TI);
    load_n(ri, sr + t * HD + ty * TI);
    load_n(vj, sv + t * HD + tx * TI);
    load_n(dj, sdo + t * HD + tx * TI);
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int b = 0; b < TI; ++b) {
        au[a][b] = fmaf(ki[a], vj[b], au[a][b]);
        av[a][b] = fmaf(ri[a], dj[b], av[a][b]);
      }
  }
  float* uo = us + cs * HD * HD;
  float* vo = vs + cs * HD * HD;
#pragma unroll
  for (int a = 0; a < TI; ++a)
#pragma unroll
    for (int b = 0; b < TI; ++b) {
      const int o = (ty * TI + a) * HD + tx * TI + b;
      uo[o] = au[a][b];
      vo[o] = av[a][b];
    }
}

// -- the carry over the chunks: S at each chunk's start, dS at its end ----------

__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_carry_kernel(float* __restrict__ ss, float* __restrict__ dss,
                       const float* __restrict__ gs,
                       const float* __restrict__ dstate, int hd, int nc) {
  const int E = hd * hd;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= E) return;
  const int bh = blockIdx.x, i = e / hd;
  const bool rev = blockIdx.z == 1;
  float* x = (rev ? dss : ss) + static_cast<size_t>(bh) * nc * E + e;
  const float* g = gs + static_cast<size_t>(bh) * nc * hd + i;
  float s = rev ? dstate[static_cast<size_t>(bh) * E + e] : 0.f;
  // kCarry chunks' loads in flight at a time, then their serial updates
  for (int it0 = 0; it0 < nc; it0 += kCarry) {
    float uu[kCarry], gg[kCarry];
#pragma unroll
    for (int m = 0; m < kCarry; ++m) {
      const int c = rev ? nc - 1 - (it0 + m) : it0 + m;
      const bool in = it0 + m < nc;
      uu[m] = in ? x[static_cast<size_t>(c) * E] : 0.f;
      gg[m] = in ? g[static_cast<size_t>(c) * hd] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kCarry; ++m) {
      if (it0 + m >= nc) break;
      const int c = rev ? nc - 1 - (it0 + m) : it0 + m;
      x[static_cast<size_t>(c) * E] = s;  // S entering chunk c / dS leaving it
      s = fmaf(gg[m], s, uu[m]);
    }
  }
}

// -- the chunk pass ---------------------------------------------------------------

template <typename Tin, int HD>
struct ChunkLayout {
  static constexpr int kRB = HD * HD <= 1024 ? HD : 1024 / HD;  // rows
  static constexpr int kTPR = kThreads / kRB;   // threads a row
  static constexpr int kCPT = HD / kTPR;        // neighbouring columns a thread
  static constexpr int kRS = kTPR + 1;          // a row's partials (odd)
  static_assert(kTPR <= 32 && kTPR * kCPT == HD, "a row within a warp");
  static constexpr int kE = static_cast<int>(sizeof(Tin));
  // a stage, in bytes: r, k, w of the block's rows [kTs][RB] and v, do
  // [kTs][HD] in the inputs' dtype, v . do [kTs] f32; two stages
  static constexpr int kSR = 0, kSK = kSR + kTs * kRB * kE,
                       kSW = kSK + kTs * kRB * kE, kSV = kSW + kTs * kRB * kE,
                       kSDO = kSV + kTs * HD * kE,
                       kSVDO = kSDO + kTs * HD * kE,
                       kStage = kSVDO + kTs * 4;
  static_assert(kStage % 16 == 0, "16-byte stages");
  // then, in floats: u [RB]; the state every kTs steps [kSub][RB][HD]; dv
  // by warp [kTs][kWarps][HD]; the row partials of dr, then dk and dw
  // [2][kTs][RB][kRS]
  static constexpr int kU = 0, kSt = kU + (kRB + 3) / 4 * 4,
                       kDV = kSt + kSub * kRB * HD,
                       kRed = kDV + kTs * kWarps * HD,
                       kFloats = kRed + 2 * kTs * kRB * kRS;
  static constexpr int kBytes = 2 * kStage + kFloats * 4;
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

// the sum of a row's N partials, in a fixed order: two chains, then added
template <int N>
__device__ __forceinline__ float row_sum(const float* p) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int m = 0; m + 1 < N; m += 2) {
    a += p[m];
    b += p[m + 1];
  }
  if (N % 2) a += p[N - 1];
  return a + b;
}

template <typename Tin, int HD>
__global__ void __launch_bounds__(kThreads, ChunkLayout<Tin, HD>::kMinBlocks)
rwkv6_bwd_chunk_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                       const Tin* __restrict__ v, const Tin* __restrict__ w,
                       const float* __restrict__ u,
                       const Tin* __restrict__ dout,
                       const float* __restrict__ vdo,
                       const float* __restrict__ ss,
                       const float* __restrict__ dss, Tin* __restrict__ dr,
                       Tin* __restrict__ dk, Tin* __restrict__ dw,
                       float* __restrict__ dv_part,
                       float* __restrict__ du_part, int BH, int S, int nc,
                       int n_u) {
  using L = ChunkLayout<Tin, HD>;
  constexpr int RB = L::kRB, TPR = L::kTPR, CPT = L::kCPT, RS = L::kRS;
  constexpr int kRed1 = kTs * RB * RS;           // one array of partials
  extern __shared__ __align__(16) unsigned char smem[];
  float* fl = reinterpret_cast<float*>(smem + 2 * L::kStage);
  float* su = fl + L::kU;
  float* sst = fl + L::kSt;
  float* sdv = fl + L::kDV;
  float* sred = fl + L::kRed;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = tid / TPR, q = tid % TPR;
  const int j0 = q * CPT;                        // the thread's first column
  const int bh = blockIdx.x, c = blockIdx.y, rb = blockIdx.z;
  const int i0 = rb * RB, nrb = HD / RB;
  const int t0 = c * kT, n = min(kT, S - t0);
  const int nsub = (n + kTs - 1) / kTs;
  const size_t base = static_cast<size_t>(bh) * S * HD;
  const size_t ck = ((static_cast<size_t>(bh) * nc + c) * HD + i0 + row) * HD + j0;

  if (tid < RB) su[tid] = u[static_cast<size_t>(bh % n_u) * HD + i0 + tid];

  // The stages in order: the sub-chunks 0 .. nsub - 2 forward, then nsub
  // - 1 .. 0 in reverse. Each is copied by cp.async into one of two
  // buffers while the one before it is computed (steps past the chunk
  // zero-filled).
  const int nstage = 2 * nsub - 1;
  auto sub_of = [&](int x) { return x < nsub - 1 ? x : 2 * (nsub - 1) - x; };
  auto issue = [&](int x) {
    if (x < nstage) {
      unsigned char* st = smem + (x & 1) * L::kStage;
      const int s = sub_of(x);
      const int a0 = t0 + s * kTs, ns = min(kTs, n - s * kTs);
      constexpr int kRC = RB * L::kE / 16;       // 16-byte chunks a row
      for (int e = tid; e < 3 * kTs * kRC; e += kThreads) {
        const int a = e / (kTs * kRC), t = (e / kRC) % kTs, cc = e % kRC;
        const Tin* src = a == 0 ? r : a == 1 ? k : w;
        const bool in = t < ns;
        const size_t off = base + static_cast<size_t>(a0 + t) * HD + i0;
        cp_async16(smem_addr(st + L::kSR + (a * kTs * RB + t * RB) * L::kE +
                             16 * cc),
                   in ? reinterpret_cast<const unsigned char*>(src + off) + 16 * cc
                      : reinterpret_cast<const unsigned char*>(src),
                   in);
      }
      constexpr int kHC = HD * L::kE / 16;
      for (int e = tid; e < 2 * kTs * kHC; e += kThreads) {
        const int a = e / (kTs * kHC), t = (e / kHC) % kTs, cc = e % kHC;
        const Tin* src = a == 0 ? v : dout;
        const bool in = t < ns;
        const size_t off = base + static_cast<size_t>(a0 + t) * HD;
        cp_async16(smem_addr(st + L::kSV + (a * kTs * HD + t * HD) * L::kE +
                             16 * cc),
                   in ? reinterpret_cast<const unsigned char*>(src + off) + 16 * cc
                      : reinterpret_cast<const unsigned char*>(src),
                   in);
      }
      if (tid < kTs / 4) {           // v . do, zero past the chunk's steps
        const float* src = vdo + (static_cast<size_t>(bh) * nc + c) * kT +
                           s * kTs + 4 * tid;
        cp_async16(smem_addr(st + L::kSVDO + 16 * tid), src, true);
      }
    }
    cp_async_commit();
  };

  float st[CPT];
  load_n(st, ss + ck);
  float ds[CPT];
  load_n(ds, dss + ck);
  float du_acc = 0.f;
  issue(0);
  for (int x = 0; x < nstage; ++x) {
    issue(x + 1);
    cp_async_wait<1>();
    __syncthreads();                 // stage x has landed for every thread
    const unsigned char* sb = smem + (x & 1) * L::kStage;
    const Tin* sr = reinterpret_cast<const Tin*>(sb + L::kSR);
    const Tin* sk = sr + kTs * RB;
    const Tin* sw = sk + kTs * RB;
    const Tin* sv = reinterpret_cast<const Tin*>(sb + L::kSV);
    const Tin* sdo = sv + kTs * HD;
    const float* svdo = reinterpret_cast<const float*>(sb + L::kSVDO);
    const int s = sub_of(x);
    if (x < nsub - 1) {
      // -- forward: keep the state at the sub-chunk's start, step 16 steps
      store_n(sst + (s * RB + row) * HD + j0, st);  // the thread's own entries
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        const float wt = to_f32(sw[t * RB + row]), kt = to_f32(sk[t * RB + row]);
        float vv[CPT];
        load_in(vv, sv + t * HD + j0);
#pragma unroll
        for (int m = 0; m < CPT; ++m) st[m] = fmaf(wt, st[m], kt * vv[m]);
      }
    } else {
      // -- a sub-chunk in reverse
      const int a0 = t0 + s * kTs;
      const int ns = min(kTs, n - s * kTs);
      if (s == nsub - 1) store_n(sst + (s * RB + row) * HD + j0, st);
      // the states before each step, from the sub-chunk's start; dr's row
      // partials on the way
      float sts[kTs][CPT];
      load_n(sts[0], sst + (s * RB + row) * HD + j0);
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        float dd[CPT];
        load_in(dd, sdo + t * HD + j0);
        float a = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; ++m) a = fmaf(sts[t][m], dd[m], a);
        sred[(t * RB + row) * RS + q] = a;
        if (t + 1 < kTs) {
          const float wt = to_f32(sw[t * RB + row]),
                      kt = to_f32(sk[t * RB + row]);
          float vv[CPT];
          load_in(vv, sv + t * HD + j0);
#pragma unroll
          for (int m = 0; m < CPT; ++m)
            sts[t + 1][m] = fmaf(wt, sts[t][m], kt * vv[m]);
        }
      }
      if (q == 0)
        for (int t = 0; t < ns; ++t)
          du_acc = fmaf(to_f32(sr[t * RB + row]) * to_f32(sk[t * RB + row]),
                        svdo[t], du_acc);
      __syncthreads();
      for (int e = tid; e < ns * RB; e += kThreads) {
        const int t = e / RB, i = e % RB;
        const float a = row_sum<TPR>(sred + e * RS);
        dr[base + static_cast<size_t>(a0 + t) * HD + i0 + i] =
            from_f32<Tin>(fmaf(su[i] * svdo[t], to_f32(sk[e]), a));
      }
      __syncthreads();               // dr's partials are read
      // dS carried back through the sub-chunk
#pragma unroll
      for (int t = kTs - 1; t >= 0; --t) {
        if (t >= ns) continue;
        const float wt = to_f32(sw[t * RB + row]), kt = to_f32(sk[t * RB + row]),
                    rt = to_f32(sr[t * RB + row]);
        const float ruk = rt * su[row] * kt;
        float vv[CPT], dd[CPT], dvp[CPT];
        load_in(vv, sv + t * HD + j0);
        load_in(dd, sdo + t * HD + j0);
        float ak = 0.f, aw = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          ak = fmaf(ds[m], vv[m], ak);
          aw = fmaf(ds[m], sts[t][m], aw);
          dvp[m] = fmaf(ds[m], kt, ruk * dd[m]);
          ds[m] = fmaf(wt, ds[m], rt * dd[m]);
        }
        sred[(t * RB + row) * RS + q] = ak;
        sred[kRed1 + (t * RB + row) * RS + q] = aw;
        // dv over the rows of the warp (lanes TPR apart), then by warp
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
          for (int m = 0; m < CPT; ++m)
            dvp[m] += __shfl_xor_sync(0xffffffffu, dvp[m], off);
        if (lane < TPR) store_n(sdv + (t * kWarps + warp) * HD + j0, dvp);
      }
      __syncthreads();
      for (int e = tid; e < ns * RB; e += kThreads) {
        const int t = e / RB, i = e % RB;
        const float a = row_sum<TPR>(sred + e * RS);
        const float b = row_sum<TPR>(sred + kRed1 + e * RS);
        const size_t off = base + static_cast<size_t>(a0 + t) * HD + i0 + i;
        dk[off] = from_f32<Tin>(fmaf(su[i] * svdo[t], to_f32(sr[e]), a));
        dw[off] = from_f32<Tin>(b);
      }
      for (int e = tid; e < ns * HD; e += kThreads) {
        const int t = e / HD, j = e % HD;
        float a = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) a += sdv[(t * kWarps + ww) * HD + j];
        dv_part[((static_cast<size_t>(bh) * nrb + rb) * S + a0 + t) * HD + j] = a;
      }
    }
    __syncthreads();                 // stage x's buffer is free for x + 2
  }
  // du by (chunk, head): the sum over both runs chunk-major
  if (q == 0)
    du_part[(static_cast<size_t>(c) * BH + bh) * HD + i0 + row] = du_acc;
}

template <typename Tin, int HD>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const float* u, const void* dout, const float* dstate, void* dr,
              void* dk, void* dv, void* dw, float* du, float* ckpt,
              float* dv_part, float* du_part, int bh, int n_u, int S,
              cudaStream_t stream) {
  using L = ChunkLayout<Tin, HD>;
  using SL = SumLayout<HD>;
  static_assert(L::kBytes <= 232448 && SL::kBytes <= 232448, "shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_bwd_chunk_kernel<Tin, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const cudaError_t sattr = cudaFuncSetAttribute(
      rwkv6_bwd_sum_kernel<Tin, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SL::kBytes);
  if (sattr != cudaSuccess) return static_cast<int>(sattr);
  const int nrb = HD / L::kRB;
  const int nc = (S + kT - 1) / kT;
  const size_t E = static_cast<size_t>(HD) * HD;
  float* ss = ckpt;                                  // U, then S
  float* dss = ckpt + static_cast<size_t>(bh) * nc * E;  // V, then dS
  float* gs = dss + static_cast<size_t>(bh) * nc * E;    // g
  float* vdo = gs + static_cast<size_t>(bh) * nc * HD;   // v . do
  const Tin* rt = static_cast<const Tin*>(r);
  const Tin* kt = static_cast<const Tin*>(k);
  const Tin* vt = static_cast<const Tin*>(v);
  const Tin* wt = static_cast<const Tin*>(w);
  const Tin* dot = static_cast<const Tin*>(dout);
  rwkv6_bwd_sum_kernel<Tin, HD><<<dim3(bh, nc), kThreads, SL::kBytes,
                                  stream>>>(rt, kt, vt, wt, dot, ss, dss, gs,
                                            vdo, S, nc);
  rwkv6_bwd_carry_kernel<<<dim3(bh, (HD * HD + kThreads - 1) / kThreads, 2),
                           kThreads, 0, stream>>>(ss, dss, gs, dstate, HD,
                                                  nc);
  rwkv6_bwd_chunk_kernel<Tin, HD><<<dim3(bh, nc, nrb), kThreads, L::kBytes,
                                    stream>>>(
      rt, kt, vt, wt, u, dot, vdo, ss, dss, static_cast<Tin*>(dr),
      static_cast<Tin*>(dk), static_cast<Tin*>(dw), dv_part, du_part, bh, S,
      nc, n_u);
  const long long SE = static_cast<long long>(S) * HD;
  sum_partials<Tin>(dv_part, static_cast<Tin*>(dv), bh, SE, nrb, nrb * SE, SE,
                    stream);
  // du[n] = the sum over (c, m), chunk-major, of du_part[(c BH + m NU + n)]
  sum_partials<float>(du_part, du, n_u, HD, nc * (bh / n_u), HD,
                      static_cast<long long>(n_u) * HD, stream);
  return 0;
}

template <typename Tin>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const void* dout, const float* dstate, void* dr,
           void* dk, void* dv, void* dw, float* du, float* ckpt,
           float* dv_part, float* du_part, int bh, int n_u, int S, int hd,
           cudaStream_t stream) {
#define REPRO_RWKV_BWD_HD(HD)                                                 \
  case HD:                                                                    \
    return launch_hd<Tin, HD>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw,    \
                              du, ckpt, dv_part, du_part, bh, n_u, S, stream);
  switch (hd) {
    REPRO_RWKV_BWD_HD(16)
    REPRO_RWKV_BWD_HD(32)
    REPRO_RWKV_BWD_HD(64)
    REPRO_RWKV_BWD_HD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_RWKV_BWD_HD
}

}  // namespace
}  // namespace repro

extern "C" int repro_rwkv6_scan_bwd(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* dout,
                                    const void* dstate, void* dr, void* dk,
                                    void* dv, void* dw, void* du, void* ckpt,
                                    void* dv_part, void* du_part, int bh,
                                    int n_u, int S, int hd, int dtype,
                                    void* stream) {
  if (n_u <= 0 || bh % n_u != 0 || S <= 0 || (S + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* aligned[] = {r, k, v, w, dout, ckpt};   // 16-byte accesses
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const float* uf = static_cast<const float*>(u);
  const float* dsf = static_cast<const float*>(dstate);
  float* duf = static_cast<float*>(du);
  float* ckf = static_cast<float*>(ckpt);
  float* dvp = static_cast<float*>(dv_part);
  float* dup = static_cast<float*>(du_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(r, k, v, w, uf, dout, dsf, dr, dk, dv,
                                      dw, duf, ckf, dvp, dup, bh, n_u, S, hd,
                                      s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(r, k, v, w, uf, dout, dsf, dr, dk, dv, dw, duf,
                              ckf, dvp, dup, bh, n_u, S, hd, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
