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
// sum over i. Nothing divides by w, which may be exactly 0, so S_{t-1} is
// never recovered from S_t: it is recomputed from a checkpoint.
//
// rwkv6_bwd_kernel: grid (BH, hd / RB), a block a head's RB rows of the
// state (RB hd = 1024 entries; RB = hd at hd 16 and 32), 256 threads, a
// thread CPT columns q, q + TPR, .. of one row (TPR threads a row).
// - Pass 1 steps the block's rows forward over chunks of kT = 16 steps,
//   writes the state at each chunk's start to a checkpoint (BH, nc, hd,
//   hd) f32 and forms dr (the row sums over j of a chunk's steps go
//   through shared memory once a chunk, summed in order) and each row's
//   du over the steps.
// - Pass 2 walks the chunks in reverse: it recomputes the chunk's kT
//   states from its checkpoint into registers (the same arithmetic as
//   pass 1, so the same bits), then carries dS back through them, forming
//   the partial sums of dk and dw (rows, through shared memory) and dv
//   (columns: first across the rows of a warp with shuffles, then across
//   the warps in order), written as a partial a row block.
// - sum_partials_kernel (common.cuh): dv summed over the row blocks, du
//   over the heads of a u row, in order. No float atomics: two calls give
//   the same bits.
// Everything is f32 on the CUDA cores, the state held at the forward's
// 2e-5 (tensor cores would need 3xTF32 for it). Bound on an H100:
// operations, 2 hd^2 flops a step for each of the two passes' state
// steps and the recomputation, and 2 hd^2 each for dr, dk, dw, dv and the
// carry of dS; chip_smoke.py counts them (rwkv_bwd_flops). At rwkv6-1.6b's
// training microbatch (BH 64, S 4096, hd 64, f32): 13 GFLOP, 0.195 ms at
// 67 TFLOP/s (bytes 0.18 ms); measured on an H100 (700 W) 4.38 ms, 0.04
// of the bound: 256 blocks, each 8,192 dependent steps, bound by the
// latency of a step, not by its FMAs. Any S is taken.
// tests/test_torch_scan_grad.py emulates this on the CPU.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;             // steps between checkpoints (a chunk)

template <int HD>
struct BwdLayout {
  static constexpr int kRB = HD * HD <= 1024 ? HD : 1024 / HD;  // rows
  static constexpr int kTPR = kThreads / kRB;   // threads a row
  static constexpr int kCPT = HD / kTPR;        // columns a thread
  static constexpr int kRS = kTPR + 1;          // a row's partials (odd)
  static_assert(kTPR <= 32 && kTPR * kCPT == HD, "a row within a warp");
  // floats: r, k, w of the block's rows [kT][RB]; v, do [kT][HD]; v . do
  // [kT]; u [RB]; dv by warp [kT][kWarps][HD]; the row partials of dr (pass
  // 1) or dk and dw (pass 2) [2][kT][RB][kRS]
  static constexpr int kR = 0, kK = kR + kT * kRB, kW = kK + kT * kRB,
                       kV = kW + kT * kRB, kDO = kV + kT * HD,
                       kVDO = kDO + kT * HD, kU = kVDO + kT,
                       kDV = kU + kRB, kRed = kDV + kT * kWarps * HD,
                       kFloats = kRed + 2 * kT * kRB * kRS;
  static constexpr int kBytes = kFloats * 4;
};

template <typename Tin, int HD>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_bwd_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, const Tin* __restrict__ w,
                 const float* __restrict__ u, const Tin* __restrict__ dout,
                 const float* __restrict__ dstate, Tin* __restrict__ dr,
                 Tin* __restrict__ dk, Tin* __restrict__ dw,
                 float* __restrict__ ckpt, float* __restrict__ dv_part,
                 float* __restrict__ du_part, int S, int n_u) {
  using L = BwdLayout<HD>;
  constexpr int RB = L::kRB, TPR = L::kTPR, CPT = L::kCPT, RS = L::kRS;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem + L::kR;
  float* sk = smem + L::kK;
  float* sw = smem + L::kW;
  float* sv = smem + L::kV;
  float* sdo = smem + L::kDO;
  float* svdo = smem + L::kVDO;
  float* su = smem + L::kU;
  float* sdv = smem + L::kDV;
  float* sred = smem + L::kRed;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = tid / TPR, q = tid % TPR;
  const int bh = blockIdx.x, rb = blockIdx.y, i0 = rb * RB;
  const int nrb = HD / RB;
  const size_t base = static_cast<size_t>(bh) * S * HD;
  const int nc = (S + kT - 1) / kT;

  if (tid < RB) su[tid] = u[static_cast<size_t>(bh % n_u) * HD + i0 + tid];

  // Chunk c's inputs (steps past S zero) and v_t . do_t, summed by a warp
  // in a fixed order.
  auto stage = [&](int c) {
    const int t0 = c * kT;
    __syncthreads();                 // the previous chunk has been read
    for (int e = tid; e < kT * RB; e += kThreads) {
      const int t = e / RB, i = e % RB;
      const bool in = t0 + t < S;
      const size_t off = base + static_cast<size_t>(t0 + t) * HD + i0 + i;
      sr[e] = in ? to_f32(r[off]) : 0.f;
      sk[e] = in ? to_f32(k[off]) : 0.f;
      sw[e] = in ? to_f32(w[off]) : 0.f;
    }
    for (int e = tid; e < kT * HD; e += kThreads) {
      const int t = e / HD, j = e % HD;
      const bool in = t0 + t < S;
      const size_t off = base + static_cast<size_t>(t0 + t) * HD + j;
      sv[e] = in ? to_f32(v[off]) : 0.f;
      sdo[e] = in ? to_f32(dout[off]) : 0.f;
    }
    __syncthreads();
    for (int t = warp; t < kT; t += kWarps) {
      float a = 0.f;
      for (int j = lane; j < HD; j += 32)
        a = fmaf(sv[t * HD + j], sdo[t * HD + j], a);
      a = warp_sum(a);
      if (lane == 0) svdo[t] = a;
    }
    __syncthreads();
  };

  // The row sums of the threads' partials part[t] (sred at `off`), for the
  // steps t < n: thread e < kT RB takes step e / RB of row e % RB.
  auto row_partials = [&](const float (&part)[kT], int off) {
#pragma unroll
    for (int t = 0; t < kT; ++t) sred[off + (t * RB + row) * RS + q] = part[t];
  };

  // -- pass 1: checkpoints, dr, du ----------------------------------------------
  float st[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) st[m] = 0.f;
  float du_acc = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kT, n = min(kT, S - t0);
    stage(c);
    float* ck = ckpt + ((static_cast<size_t>(bh) * nc + c) * HD + i0 + row) * HD;
#pragma unroll
    for (int m = 0; m < CPT; ++m) ck[q + TPR * m] = st[m];
    float acc[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      acc[t] = 0.f;
      if (t < n) {
        const float wt = sw[t * RB + row], kt = sk[t * RB + row];
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int j = q + TPR * m;
          acc[t] = fmaf(st[m], sdo[t * HD + j], acc[t]);
          st[m] = fmaf(wt, st[m], kt * sv[t * HD + j]);
        }
      }
    }
    if (q == 0)
      for (int t = 0; t < n; ++t)
        du_acc = fmaf(sr[t * RB + row] * sk[t * RB + row], svdo[t], du_acc);
    row_partials(acc, 0);
    __syncthreads();
    for (int e = tid; e < kT * RB; e += kThreads) {
      const int t = e / RB, i = e % RB;
      if (t < n) {
        float a = 0.f;
        for (int qq = 0; qq < TPR; ++qq) a += sred[e * RS + qq];
        a = fmaf(su[i] * sk[e], svdo[t], a);
        dr[base + static_cast<size_t>(t0 + t) * HD + i0 + i] = from_f32<Tin>(a);
      }
    }
  }
  if (q == 0) du_part[static_cast<size_t>(bh) * HD + i0 + row] = du_acc;

  // -- pass 2: the chunks in reverse, dS carried back ----------------------------
  float ds[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m)
    ds[m] = dstate[(static_cast<size_t>(bh) * HD + i0 + row) * HD + q + TPR * m];
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kT, n = min(kT, S - t0);
    stage(c);
    const float* ck =
        ckpt + ((static_cast<size_t>(bh) * nc + c) * HD + i0 + row) * HD;
    float sts[kT][CPT];              // the state before each step
#pragma unroll
    for (int m = 0; m < CPT; ++m) sts[0][m] = ck[q + TPR * m];
#pragma unroll
    for (int t = 0; t + 1 < kT; ++t) {
      const float wt = sw[t * RB + row], kt = sk[t * RB + row];
#pragma unroll
      for (int m = 0; m < CPT; ++m)
        sts[t + 1][m] = fmaf(wt, sts[t][m], kt * sv[t * HD + q + TPR * m]);
    }
    float ak[kT], aw[kT];
#pragma unroll
    for (int t = kT - 1; t >= 0; --t) {
      ak[t] = aw[t] = 0.f;
      if (t < n) {
        const float wt = sw[t * RB + row], kt = sk[t * RB + row],
                    rt = sr[t * RB + row];
        const float ruk = rt * su[row] * kt;
        float dvp[CPT];
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int j = q + TPR * m;
          const float vj = sv[t * HD + j], dj = sdo[t * HD + j];
          ak[t] = fmaf(ds[m], vj, ak[t]);
          aw[t] = fmaf(ds[m], sts[t][m], aw[t]);
          dvp[m] = fmaf(ds[m], kt, ruk * dj);
          ds[m] = fmaf(wt, ds[m], rt * dj);
        }
        // dv over the rows of the warp (lanes TPR apart), then by warp
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
          for (int m = 0; m < CPT; ++m)
            dvp[m] += __shfl_xor_sync(0xffffffffu, dvp[m], off);
        if (lane < TPR) {
#pragma unroll
          for (int m = 0; m < CPT; ++m)
            sdv[(t * kWarps + warp) * HD + q + TPR * m] = dvp[m];
        }
      }
    }
    row_partials(ak, 0);
    row_partials(aw, kT * RB * RS);
    __syncthreads();
    for (int e = tid; e < kT * RB; e += kThreads) {
      const int t = e / RB, i = e % RB;
      if (t < n) {
        float a = 0.f, b = 0.f;
        for (int qq = 0; qq < TPR; ++qq) {
          a += sred[e * RS + qq];
          b += sred[kT * RB * RS + e * RS + qq];
        }
        a = fmaf(sr[e] * su[i], svdo[t], a);
        const size_t off = base + static_cast<size_t>(t0 + t) * HD + i0 + i;
        dk[off] = from_f32<Tin>(a);
        dw[off] = from_f32<Tin>(b);
      }
    }
    for (int e = tid; e < kT * HD; e += kThreads) {
      const int t = e / HD, j = e % HD;
      if (t < n) {
        float a = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) a += sdv[(t * kWarps + ww) * HD + j];
        dv_part[((static_cast<size_t>(bh) * nrb + rb) * S + t0 + t) * HD + j] = a;
      }
    }
  }
}

template <typename Tin, int HD>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const float* u, const void* dout, const float* dstate, void* dr,
              void* dk, void* dv, void* dw, float* du, float* ckpt,
              float* dv_part, float* du_part, int bh, int n_u, int S,
              cudaStream_t stream) {
  using L = BwdLayout<HD>;
  static_assert(L::kBytes <= 232448, "shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_bwd_kernel<Tin, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nrb = HD / L::kRB;
  rwkv6_bwd_kernel<Tin, HD><<<dim3(bh, nrb), kThreads, L::kBytes, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const Tin*>(w), u,
      static_cast<const Tin*>(dout), dstate, static_cast<Tin*>(dr),
      static_cast<Tin*>(dk), static_cast<Tin*>(dw), ckpt, dv_part, du_part, S,
      n_u);
  const long long E = static_cast<long long>(S) * HD;
  sum_partials<Tin>(dv_part, static_cast<Tin*>(dv), bh, E, nrb, nrb * E, E,
                    stream);
  // du[n] = sum over m of du_part[m NU + n]
  sum_partials<float>(du_part, du, n_u, HD, bh / n_u, HD,
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
  if (n_u <= 0 || bh % n_u != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
