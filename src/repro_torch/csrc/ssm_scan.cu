// ssm_scan: the Mamba2 (SSD) selective scan of one sequence per head.
// xbar (BH, S, hd) f32 dt-weighted inputs, B/C (BH_bc, S, ds) bf16 or f32
// (row bh reads B/C row bh / (BH / BH_bc): the heads of a sequence share
// one B/C group), cumlog (BH, S) f32, the cumulative log-decay reset at
// every `chunk` steps. Writes y (BH, S, hd) f32 and the final state
// h (BH, hd, ds) f32, from a zero initial state. S need not be a chunk
// multiple: a short last chunk is the same function as one padded with
// zero inputs and zero log-decay.
//
// Replaces the Pallas TPU kernel ssm_scan / _ssm_kernel
// (src/repro/kernels/ssm_scan.py:49, body :18), which computes each chunk
// in the quadratic SSD form, (C B^T o L) xbar with L = exp(cum_i - cum_j),
// on the MXU, and drops the final state. Here the same function is
// computed as its recurrence (the semantics of ssm_scan_ref):
//   h_t = a_t h_{t-1} + xbar_t^T B_t,   y_t = h_t C_t,
//   a_t = exp(cum_t - cum_{t-1})  (cum_{t-1} = 0 at a chunk start).
// On CUDA cores the quadratic form at the serving chunk of 256 costs
// Q (hd + ds) / (hd ds) ~ 8x the multiply-adds of the recurrence, and its
// f32 (Q, Q) decay matrix alone (256 KB) exceeds a block's shared memory.
//
// Bound on an H100: operations. Two multiply-adds per state element per
// step (4 BH S hd ds flops, f32 on CUDA cores at 67 TFLOP/s) against
// ~8 BH S hd bytes of xbar and y: ds / 2 = 32 flops a byte at ds = 64,
// above the f32 ridge of 67 / 3.35 = 20.
//
// Design: the rows p of h are independent chains (row p sees only
// xbar[p]), so a block takes kRows = 16 rows of one head: grid
// (BH, hd / 16), 256 threads, 16 threads a row. Thread q of a row keeps
// the states s = q, q + 16, ... in registers for the whole sequence. The
// inputs of kT = 32 steps are staged in shared memory (B/C converted to
// f32 once, the step decay a_t computed once per step); y_t[p] is summed
// across the 16 threads of the row with shuffles and staged, so each
// tile's y leaves as one coalesced write.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 16;          // rows of hd per block
constexpr int kTPR = 16;           // threads per row
constexpr int kThreads = kRows * kTPR;
constexpr int kT = 32;             // steps per staged tile

template <typename TB, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ xbar, const TB* __restrict__ Bm,
                const TB* __restrict__ Cm, const float* __restrict__ cum,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int hd, int group, int chunk) {
  constexpr int kNS = DS / kTPR;   // states per thread
  __shared__ float sx[kT][kRows];
  __shared__ float sB[kT][DS];
  __shared__ float sC[kT][DS];
  __shared__ float sa[kT];
  __shared__ float sy[kT][kRows];

  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kRows;
  const int r = threadIdx.x / kTPR;   // row within the block
  const int q = threadIdx.x % kTPR;   // state slice within the row
  const int bc = bh / group;
  const float* xb = xbar + static_cast<size_t>(bh) * S * hd;
  const TB* Bb = Bm + static_cast<size_t>(bc) * S * DS;
  const TB* Cb = Cm + static_cast<size_t>(bc) * S * DS;
  const float* cb = cum + static_cast<size_t>(bh) * S;

  float h[kNS];
#pragma unroll
  for (int m = 0; m < kNS; ++m) h[m] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    for (int i = threadIdx.x; i < kT * DS; i += kThreads) {
      const int t = i / DS, s = i % DS;
      const bool in = t < n;
      const size_t off = static_cast<size_t>(t0 + t) * DS + s;
      sB[t][s] = in ? to_f32(Bb[off]) : 0.f;
      sC[t][s] = in ? to_f32(Cb[off]) : 0.f;
    }
    for (int i = threadIdx.x; i < kT * kRows; i += kThreads) {
      const int t = i / kRows, c = i % kRows;
      const int p = p0 + c;
      sx[t][c] = (t < n && p < hd)
                     ? xb[static_cast<size_t>(t0 + t) * hd + p] : 0.f;
    }
    if (threadIdx.x < kT) {
      const int t = t0 + threadIdx.x;
      float a = 1.f;
      if (threadIdx.x < n) {
        const float prev = (t % chunk == 0) ? 0.f : cb[t - 1];
        a = expf(cb[t] - prev);
      }
      sa[threadIdx.x] = a;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float a = sa[t];
      const float x = sx[t][r];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kNS; ++m) {
        const int s = q + kTPR * m;
        h[m] = fmaf(a, h[m], x * sB[t][s]);
        acc = fmaf(h[m], sC[t][s], acc);
      }
#pragma unroll
      for (int off = kTPR / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (q == 0) sy[t][r] = acc;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n * kRows; i += kThreads) {
      const int t = i / kRows, c = i % kRows;
      const int p = p0 + c;
      if (p < hd) y[(static_cast<size_t>(bh) * S + t0 + t) * hd + p] = sy[t][c];
    }
    __syncthreads();  // the next tile overwrites the staged inputs and sy
  }

  const int p = p0 + r;
  if (p < hd) {
#pragma unroll
    for (int m = 0; m < kNS; ++m)
      h_out[(static_cast<size_t>(bh) * hd + p) * DS + q + kTPR * m] = h[m];
  }
}

template <typename TB, int DS>
void launch_ds(const float* xbar, const void* B, const void* C,
               const float* cum, float* y, float* h, int bh, int S, int hd,
               int group, int chunk, cudaStream_t stream) {
  const dim3 grid(bh, (hd + kRows - 1) / kRows);
  ssm_scan_kernel<TB, DS><<<grid, kThreads, 0, stream>>>(
      xbar, static_cast<const TB*>(B), static_cast<const TB*>(C), cum, y, h,
      S, hd, group, chunk);
}

template <typename TB>
int launch(const float* xbar, const void* B, const void* C, const float* cum,
           float* y, float* h, int bh, int S, int hd, int ds, int group,
           int chunk, cudaStream_t stream) {
  switch (ds) {
    case 16: launch_ds<TB, 16>(xbar, B, C, cum, y, h, bh, S, hd, group, chunk, stream); break;
    case 32: launch_ds<TB, 32>(xbar, B, C, cum, y, h, bh, S, hd, group, chunk, stream); break;
    case 64: launch_ds<TB, 64>(xbar, B, C, cum, y, h, bh, S, hd, group, chunk, stream); break;
    case 128: launch_ds<TB, 128>(xbar, B, C, cum, y, h, bh, S, hd, group, chunk, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" int repro_ssm_scan(const void* xbar, const void* B, const void* C,
                              const void* cumlog, void* y, void* h, int bh,
                              int bh_bc, int S, int hd, int ds, int chunk,
                              int dtype, void* stream) {
  if (bh_bc <= 0 || bh % bh_bc != 0 || chunk <= 0 || S <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bh_bc;
  const float* xb = static_cast<const float*>(xbar);
  const float* cl = static_cast<const float*>(cumlog);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(xb, B, C, cl, yo, ho, bh, S, hd, ds, group, chunk, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(xb, B, C, cl, yo, ho, bh, S, hd, ds, group, chunk, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
