// rwkv6_scan: the RWKV6 ("Finch") time-mix recurrence with a per-channel,
// data-dependent decay, one sequence per head.
// r, k, v, w (BH, S, hd) bf16 or f32 (w the decay, in (0, 1)), u (NU, hd)
// f32 the per-head bonus (row bh reads u row bh % NU: u is shared by the
// batch). Writes o (BH, S, hd) in the inputs' dtype and the final state
// S (BH, hd, hd) f32, indexed [key d][value c], from a zero initial state:
//   o_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t.
//
// Replaces the Pallas TPU kernel rwkv6_scan / _rwkv_kernel
// (src/repro/kernels/rwkv6_scan.py:46, body :17), which steps the same
// recurrence over (hd, hd) states kept in VMEM across a sequential grid
// of chunks and drops the final state. Blocks on the card have no order,
// so the whole sequence runs inside one block; any S is taken.
//
// Bound on an H100. f32 inputs (what the rwkv6 serving path passes):
// bytes. At rwkv6-1.6b's shape (BH 32, S 600, hd 64) r, k, v, w and o
// are 24.6 MB and the state 0.5 MB: 0.0075 ms at 3.35 TB/s, against
// ~0.39 GFLOP of the chunked form below, 0.0058 ms at the 67 TFLOP/s f32
// peak. bf16 inputs move 12.8 MB (0.0038 ms) and are bound by the same
// operations.
//
// Design: the recurrence regrouped into chunks of kT = 16 steps, on the
// CUDA cores in f32. Within a chunk of n steps (the last may be short),
// per key channel d, with every decay a product of w's:
//   a_i = prod_{m<i} w_m,  b_j = prod_{j<m<n} w_m,  g = prod_{m<n} w_m,
//   D_ij = prod_{j<m<i} w_m (j < i), a running product along i;
//   A[i][j] = sum_d r_i[d] k_j[d] D_ij[d] (j < i), A[i][i] = r_i . (u k_i)
//   o_i = (r_i a_i) S0 + sum_{j<=i} A[i][j] v_j
//   S  <- diag(g) S0 + sum_j (k_j b_j)^T v_j.
// No exp, log or division: the products of numbers in [0, 1] cannot
// overflow, a 0 or a 1 in w is exact, and no clamp of w is needed (the
// e^{-c} factorisation of the JAX model's _time_mix_chunked overflows f32
// without its clamp; D is never formed as a_i / a_{j+1}, an underflowing
// 0 / 0). tests/test_torch_rwkv_design.py emulates this on the CPU.
//
// Why the CUDA cores and not the tensor cores: the serving path is f32
// and the state is held at 2e-5; one TF32 rounding of the operands misses
// that (tests/test_torch_ssm_design.py shows it for the ssm scan), so each
// product would need 3xTF32, and the FMA units are not what bounds this
// kernel anyway (0.0058 ms of operations against 0.0075 ms of bytes).
//
// Layout: grid (BH, hd / 16), 256 threads; a block owns 16 value
// columns of one head's state (the columns are independent). A depends
// only on (i, j), so each column block forms it itself. One barrier a
// chunk: between two barriers a block computes chunk c's o and state
// update and prepares chunk c + 1 (prefix and suffix products, A, v
// transposed), while chunks c + 2 and c + 3 stream into a three-stage
// cp.async ring (zero-filled past S: NaN in unwritten shared memory times
// 0 would be NaN).
// - A chunk's phases spend their issue on shared-memory loads and
//   shuffles rather than on FMAs, so the layout keeps each value a lane
//   loads in use for several FMAs and keeps the state out of shared
//   memory.
// - A warp takes two value columns; a lane keeps the state of hd / 32 of
//   their channels in registers for the whole sequence. o_i is the sum
//   over the lanes of their share of r~_i S0 and of A v (lane l adds
//   A[i][l % 16] v_{l % 16} for column l / 16), folded across the warp
//   with 31 shuffles (a lane keeps the half of what is left that its lane
//   bit names); the update needs no exchange.
// - A warp forms the columns j and 15 - j of A (17 entries on or below
//   the diagonal in every warp, one branch-free loop), its lanes over the
//   channels, folded the same way.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;              // steps a chunk: a warp forms 2 columns of A
constexpr int kVC = 16;             // value columns a block: a warp takes 2
constexpr int kStages = 3;          // chunks in the cp.async ring
constexpr int kSmemMax = 232448;    // dynamic shared memory a block
static_assert(kT == 2 * kWarps && kVC == 2 * kWarps, "a warp's columns");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared, 16 bytes; zero-fill the destination when !pred (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N (1, 2 or 4) consecutive elements at p, aligned to their size, as f32
__device__ __forceinline__ void bf16x2_f32(uint32_t x, float* out) {
  out[0] = __uint_as_float(x << 16);
  out[1] = __uint_as_float(x & 0xffff0000u);
}
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "vector width");
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void ld_f32(const __nv_bfloat16* p,
                                       float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "vector width");
  if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    bf16x2_f32(x.x, out); bf16x2_f32(x.y, out + 2);
  } else if constexpr (N == 2) {
    bf16x2_f32(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

// Sum acc[N] over the lanes O, O/2, .. 1 apart, halving at each step: a
// lane keeps the half of its values that its lane bit O names and adds its
// partner's (H values each way); once one value is left (H = 0), partners
// add theirs. From fold<N/2, 16>, lane q ends with the sum of value
// q * N/32 in acc[0] (N >= 32), or of value q >> log2(32/N) (N < 32).
template <int H, int O, int N>
__device__ __forceinline__ void fold(float (&acc)[N], int lane) {
  if constexpr (O >= 1) {
    if constexpr (H >= 1) {
      const bool up = lane & O;
#pragma unroll
      for (int m = 0; m < H; ++m) {
        const float send = up ? acc[m] : acc[m + H];
        const float keep = up ? acc[m + H] : acc[m];
        acc[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], O);
    }
    fold<H / 2, O / 2>(acc, lane);
  }
}

// Shared memory, in bytes from the start: kStages stages of raw inputs and
// two buffers of what a chunk's o and update read.
template <typename Tin, int HD>
struct Layout {
  static constexpr int kTA = kT + 4;         // a row of A^T and of v^T
  static constexpr int kRaw = kT * HD * sizeof(Tin);     // r, k or w
  static constexpr int kStage = 3 * kRaw + kT * kVC * sizeof(Tin);
  // r~ = r a, k~ = k b [T][HD]; A^T [T][kTA] (A^T[j][i] = A[i][j]);
  // v^T [VC][kTA]; g [HD]
  static constexpr int kRt = 0, kKt = kRt + kT * HD, kAt = kKt + kT * HD,
                       kVt = kAt + kT * kTA, kG = kVt + kVC * kTA,
                       kPrep = kG + HD;                   // floats
  static constexpr int kPrepOff = kStages * kStage;
  static constexpr int kBytes = kPrepOff + 2 * kPrep * 4;
};

template <typename Tin, int HD>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_chunk_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                   const Tin* __restrict__ v, const Tin* __restrict__ w,
                   const float* __restrict__ u, Tin* __restrict__ o,
                   float* __restrict__ s_out, int S, int n_u) {
  using L = Layout<Tin, HD>;
  constexpr int T = kT, TA = L::kTA, NS = kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kVC;
  const size_t base = static_cast<size_t>(bh) * S * HD;
  const int nc = (S + T - 1) / T;

  auto raw = [&](int ci, int a) {            // a: 0 r, 1 k, 2 w, 3 v
    return reinterpret_cast<Tin*>(smem + ci % NS * L::kStage + a * L::kRaw);
  };
  auto prep = [&](int ci) {
    return reinterpret_cast<float*>(smem + L::kPrepOff) + ci % 2 * L::kPrep;
  };

  // Start the copies of chunk ci into its stage (nothing past the end).
  auto issue = [&](int ci) {
    if (ci >= nc) return;
    constexpr int kE = 16 / sizeof(Tin);     // elements a 16-byte copy
    constexpr int kPR = HD / kE, kPV = kVC / kE;
    const int t0 = ci * T;
    for (int p = tid; p < 3 * T * kPR; p += kThreads) {
      const int a = p / (T * kPR), t = p / kPR % T, e = p % kPR * kE;
      const bool ok = t0 + t < S;
      const Tin* src = (a == 0 ? r : a == 1 ? k : w) + base;
      cp_async16(raw(ci, a) + t * HD + e,
                 ok ? src + static_cast<size_t>(t0 + t) * HD + e : src, ok);
    }
    for (int p = tid; p < T * kPV; p += kThreads) {
      const int t = p / kPV, e = p % kPV * kE;
      const bool ok = t0 + t < S;
      cp_async16(raw(ci, 3) + t * kVC + e,
                 ok ? v + base + static_cast<size_t>(t0 + t) * HD + j0 + e
                    : v + base, ok);
    }
  };

  // A lane's channels, in A, o and the update (hd 16: lanes 16-31 idle).
  constexpr int kDL = HD >= 32 ? HD / 32 : 1;
  const bool live = lane * kDL < HD;
  const int dl = min(lane * kDL, HD - kDL);
  float ur[kDL];
  ld_f32(u + static_cast<size_t>(bh % n_u) * HD + dl, ur);

  // Chunk ci from its raw stage into its prep buffer.
  auto prepare = [&](int ci) {
    const int n = min(T, S - ci * T);
    const Tin* sr = raw(ci, 0);
    const Tin* sk = raw(ci, 1);
    const Tin* sw = raw(ci, 2);
    const Tin* sv = raw(ci, 3);
    float* pb = prep(ci);
    // prefix products into r~, suffix products into k~, the total into g
    for (int task = tid; task < 2 * HD; task += kThreads) {
      const int d = task % HD;
      const bool pre = task < HD;
      const Tin* sx = pre ? sr : sk;
      float wv[T], xv[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        wv[i] = to_f32(sw[i * HD + d]);
        xv[i] = to_f32(sx[i * HD + d]);
      }
      float acc = 1.f;
      if (pre) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          pb[L::kRt + i * HD + d] = xv[i] * acc;
          acc *= wv[i];
        }
      } else {
#pragma unroll
        for (int j = T - 1; j >= 0; --j) {
          pb[L::kKt + j * HD + d] = xv[j] * acc;
          acc *= j < n ? wv[j] : 1.f;      // steps past S do not decay
        }
        pb[L::kG + d] = acc;
      }
    }
    for (int p = tid; p < T * kVC; p += kThreads)
      pb[L::kVt + p % kVC * TA + p / kVC] = to_f32(sv[p]);
    // A: the warp takes the columns ja and jb = T - 1 - ja, T + 1 entries
    // on or below the diagonal (those above it stay 0): entry q is row
    // ja + q of column ja for q < T - ja, else row q - 1 of column jb. D
    // runs along the rows and starts again at each column's diagonal.
    const int ja = warp, jb = T - 1 - ja, qb = T - ja;
    float ka[kDL], kb[kDL], dec[kDL];
    ld_f32(sk + ja * HD + dl, ka);
    ld_f32(sk + jb * HD + dl, kb);
#pragma unroll
    for (int m = 0; m < kDL; ++m) {
      if (!live) ka[m] = kb[m] = 0.f;
      dec[m] = 1.f;
    }
    auto entry = [&](int q) {
      const bool second = q >= qb, diag = q == 0 || q == qb;
      const int row = second ? q - 1 : ja + q;
      float ri[kDL], wi[kDL];
      ld_f32(sr + row * HD + dl, ri);
      ld_f32(sw + row * HD + dl, wi);
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < kDL; ++m) {
        const float kx = second ? kb[m] : ka[m];
        a = fmaf(ri[m], kx * (diag ? ur[m] : dec[m]), a);
        dec[m] = diag ? 1.f : dec[m] * wi[m];   // D_{j+1, j} = 1
      }
      return a;
    };
    float acc[T], last[1];
#pragma unroll
    for (int q = 0; q < T; ++q) acc[q] = entry(q);
    last[0] = entry(T);                      // row T - 1 of column jb
    fold<T / 2, 16>(acc, lane);              // lanes 2q, 2q + 1: entry q
    fold<0, 16>(last, lane);
    const int q = lane >> 1;
    if (!(lane & 1))
      pb[L::kAt + (q >= qb ? jb * TA + q - 1 : ja * TA + ja + q)] = acc[0];
    if (lane == 1) pb[L::kAt + jb * TA + T - 1] = last[0];
  };

  // o and the update: the warp takes the value columns c0, c0 + 1, a lane
  // the channels dl .. dl + kDL of both, whose state it keeps in st.
  const int c0 = 2 * warp;
  float st[kDL][2];
#pragma unroll
  for (int m = 0; m < kDL; ++m) st[m][0] = st[m][1] = 0.f;

  auto output = [&](int ci) {
    const int n = min(T, S - ci * T);
    const float* pb = prep(ci);
    // part[cc * T + i]: the lane's share of o_i[c0 + cc]
    float part[2 * T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float x[kDL];
      ld_f32(pb + L::kRt + i * HD + dl, x);
      part[i] = part[T + i] = 0.f;
#pragma unroll
      for (int m = 0; m < kDL; ++m) {
        part[i] = fmaf(x[m], st[m][0], part[i]);
        part[T + i] = fmaf(x[m], st[m][1], part[T + i]);
      }
    }
    // and A[i][j] v_j[c] for j = lane % T of column c0 + lane / T
    const int jl = lane % T, cl = lane / T;
    const float vl = pb[L::kVt + (c0 + cl) * TA + jl];
    const float v0 = cl == 0 ? vl : 0.f, v1 = cl == 0 ? 0.f : vl;
#pragma unroll
    for (int i = 0; i < T; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(
          pb + L::kAt + jl * TA + i);
      const float ai[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[i + e] = fmaf(ai[e], v0, part[i + e]);
        part[T + i + e] = fmaf(ai[e], v1, part[T + i + e]);
      }
    }
    fold<T, 16>(part, lane);                 // lane: o_{lane % T}[c0 + cl]
    if (jl < n)
      o[base + static_cast<size_t>(ci * T + jl) * HD + j0 + c0 + cl] =
          from_f32<Tin>(part[0]);
  };

  auto update = [&](int ci) {
    if (!live) return;
    const float* pb = prep(ci);
    float g[kDL], h[2][kDL][2];
    ld_f32(pb + L::kG + dl, g);
#pragma unroll
    for (int m = 0; m < kDL; ++m)
      h[0][m][0] = h[0][m][1] = h[1][m][0] = h[1][m][1] = 0.f;
#pragma unroll
    for (int j = 0; j < T; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(
          pb + L::kVt + c0 * TA + j);
      const float4 b = *reinterpret_cast<const float4*>(
          pb + L::kVt + (c0 + 1) * TA + j);
      const float va[4] = {a.x, a.y, a.z, a.w}, vb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x[kDL];
        ld_f32(pb + L::kKt + (j + e) * HD + dl, x);
#pragma unroll
        for (int m = 0; m < kDL; ++m) {
          h[e % 2][m][0] = fmaf(x[m], va[e], h[e % 2][m][0]);
          h[e % 2][m][1] = fmaf(x[m], vb[e], h[e % 2][m][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kDL; ++m)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        st[m][cc] = fmaf(g[m], st[m][cc], h[0][m][cc] + h[1][m][cc]);
  };

  // Chunk ci + 1 must have landed at the top of step ci; chunks up to
  // ci + NS - 1 may still be in flight.
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    issue(c);
    cp_async_commit();
  }
  for (int p = tid; p < T * TA; p += kThreads)
    prep(0)[L::kAt + p] = prep(1)[L::kAt + p] = 0.f;
  cp_async_wait<NS - 1>();             // chunk 0 has landed
  __syncthreads();
  prepare(0);
  for (int ci = 0; ci < nc; ++ci) {
    cp_async_wait<NS - 2>();           // chunk ci + 1 has landed
    __syncthreads();                   // and chunk ci is prepared
    issue(ci + NS);                    // into the stage chunk ci left
    cp_async_commit();
    output(ci);                        // from the state before chunk ci
    update(ci);
    if (ci + 1 < nc) prepare(ci + 1);
  }
  if (live) {
#pragma unroll
    for (int m = 0; m < kDL; ++m)
      *reinterpret_cast<float2*>(
          s_out + (static_cast<size_t>(bh) * HD + dl + m) * HD + j0 + c0) =
          make_float2(st[m][0], st[m][1]);
  }
}

template <typename Tin, int HD>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const float* u, void* o, float* s_out, int bh, int S, int n_u,
              cudaStream_t stream) {
  constexpr int kBytes = Layout<Tin, HD>::kBytes;
  static_assert(kBytes <= kSmemMax, "shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_chunk_kernel<Tin, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, HD / kVC);
  rwkv6_chunk_kernel<Tin, HD><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const Tin*>(w), u,
      static_cast<Tin*>(o), s_out, S, n_u);
  return 0;
}

template <typename Tin>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* o, float* s_out, int bh, int S, int hd,
           int n_u, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<Tin, 16>(r, k, v, w, u, o, s_out, bh, S, n_u, stream);
    case 32: return launch_hd<Tin, 32>(r, k, v, w, u, o, s_out, bh, S, n_u, stream);
    case 64: return launch_hd<Tin, 64>(r, k, v, w, u, o, s_out, bh, S, n_u, stream);
    case 128: return launch_hd<Tin, 128>(r, k, v, w, u, o, s_out, bh, S, n_u, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* o,
                                void* s_out, int bh, int n_u, int S, int hd,
                                int dtype, void* stream) {
  if (n_u <= 0 || bh % n_u != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* uf = static_cast<const float*>(u);
  float* so = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(r, k, v, w, uf, o, so, bh, S, hd, n_u, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(r, k, v, w, uf, o, so, bh, S, hd, n_u, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
