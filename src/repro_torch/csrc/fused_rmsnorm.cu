// fused_rmsnorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), in f32, cast to
// x's dtype. x (N, d) bf16 or f32 row-major, w (d,) f32; any N >= 1, d >= 1.
//
// Replaces the Pallas TPU kernel fused_rmsnorm / _rmsnorm_kernel
// (src/repro/kernels/fused_rmsnorm.py:19, body :11), which pads N to a
// tile of rows and normalises a (rows, d) block per grid step.
//
// Bound on an H100: bytes. Each element is read once and written once
// with ~4 flops, far below the card's ~295 flops/byte balance, so the
// least time is (2 * N * d * sizeof(T) + 4 * d) / 3.35 TB/s. At decode
// (N = 1) the kernel is launch-latency bound: two dependent trips to
// memory and the launch are all there is.
//
// Design (rmsnorm_kernel, the serving path's d of 2048 and 4096):
// - One read of x. A row goes to a group of TPR threads (64 for d in
//   (1024, 2048], 128 for d in (2048, 4096]); each thread loads its slice
//   of the row (at most 32 elements) as 16-byte vectors into registers,
//   with its slice of w as float4 in the same pass, sums the squares in
//   f32, and scales the same registers. Blocks of 256 threads hold
//   256 / TPR rows (4 at d 2048, 2 at d 4096), so the card sees fewer,
//   fuller blocks.
// - The reduction is a warp shuffle and one shared-memory exchange across
//   the row's warps, summed in a fixed order (deterministic).
// - A programmatic dependent launch: the block is scheduled while the
//   kernel before it finishes, and reads x and w only after
//   wait_previous_grid(), so either may be written by that kernel.
// rmsnorm_loop_kernel takes every other row (d not a multiple of the
// vector, a pointer not 16-byte aligned, d <= 1024 or d > 4096): a block
// of 256 threads a row, x read twice (the second time from L1/L2).
//
// The backward (repro_fused_rmsnorm_bwd; the JAX package has no backward
// kernel, its model trains through XLA's autodiff of the jnp rmsnorm,
// src/repro/models/layers.py:42). With r = rsqrt(mean(x^2) + eps) and
// g = dy (1 + w):
//   dx = r g - x r^3 / d * sum_k g_k x_k     (in x's dtype)
//   dw = sum over rows of dy x r             (f32)
// Bound: bytes (x and dy read once, dx written once; the dw partials are
// 4 d bytes a block, a few per cent of it). Two dependent launches:
// - rmsnorm_bwd_rows_kernel: at most kBwdBlocks blocks of 256 threads,
//   each walking a contiguous range of rows_per_block rows. The forward's
//   register layout: a row goes to a group of TPR threads (the least of
//   32, 64, 128, 256 with 4 16-byte vectors a thread covering d: bf16 d
//   <= 8192, f32 d <= 4096), kBlock / TPR rows a pass; each thread loads
//   its vectors of x and dy once into registers, ss and g.x are reduced
//   by warp shuffles and one shared-memory exchange across the row's
//   warps in a fixed order (double-buffered: one __syncthreads a pass),
//   and dx is written from the same registers. A thread's columns are
//   fixed, so its (1 + w) is loaded once and its dw terms of every row it
//   takes are summed in registers in row order; at the end the block's
//   row groups are summed in shared memory in group order into one f32
//   partial row a block.
// - rmsnorm_bwd_loop_kernel takes every other case (d not a multiple of
//   the vector, a misaligned pointer, wider rows): the same block range,
//   16 rows at a time with the whole block on a row, x and dy read twice,
//   the partial row carried in global memory by the thread that owns the
//   column, the rows in order.
// - rmsnorm_bwd_dw_kernel: a block of 8 warps per 32 columns (d / 32
//   blocks fill the card), warp k summing partial rows k, k + 8, ... in
//   order, then the 8 warp sums in warp order.
// No float atomics: two runs give the same bits. Both launches are
// programmatic dependent launches (they read only after
// wait_previous_grid()).
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlock = 256;      // threads a block
constexpr int kMaxElems = 32;    // x elements a thread keeps in registers

// the f32 values of a 16-byte vector of 4 f32 or 8 bf16
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int TPR>
__global__ void __launch_bounds__(kBlock)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int n, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);       // elements a 16-byte vector
  constexpr int kNV = kMaxElems / kVec;      // vectors a thread
  constexpr int kWPR = TPR / 32;             // warps a row
  static_assert(kWPR > 1, "a row of several warps");
  constexpr int kRows = kBlock / TPR;        // rows a block
  const int rib = threadIdx.x / TPR;         // row in the block
  const int t = threadIdx.x % TPR;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRows + rib;
  const bool live = row < static_cast<size_t>(n);
  const int nvec = d / kVec;

  // the kernel before this one may write x or w; both are read after it
  wait_previous_grid();
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 xv[kNV];
  float4 wv[kNV][kVec / 4];
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int v = t + i * TPR;
    xv[i] = (live && v < nvec) ? xr[v] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      wv[i][j] = v < nvec
          ? reinterpret_cast<const float4*>(w)[v * (kVec / 4) + j]
          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    float f[kVec];
    unpack16(xv[i], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss += f[e] * f[e];
  }
  ss = warp_sum(ss);
  __shared__ float partial[kRows][kWPR];
  if ((t & 31) == 0) partial[rib][t >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int k = 0; k < kWPR; ++k) ss += partial[rib][k];
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int v = t + i * TPR;
    if (!live || v >= nvec) continue;
    float f[kVec];
    unpack16(xv[i], f);
    float wf[kVec];
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      wf[4 * j] = wv[i][j].x;
      wf[4 * j + 1] = wv[i][j].y;
      wf[4 * j + 2] = wv[i][j].z;
      wf[4 * j + 3] = wv[i][j].w;
    }
    alignas(16) T e[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) e[k] = from_f32<T>(f[k] * r * (1.f + wf[k]));
    orow[v] = *reinterpret_cast<const uint4*>(e);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBlock)
rmsnorm_loop_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ out, int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  wait_previous_grid();

  float ss = 0.f;
  for (int base = threadIdx.x * VEC; base < d; base += kBlock * VEC) {
    alignas(16) T e[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xr + base);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = xr[base + i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f32(e[i]);
      ss += v * v;
    }
  }
  __shared__ float partial[kBlock / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kBlock / 32; ++i) total += partial[i];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  for (int base = threadIdx.x * VEC; base < d; base += kBlock * VEC) {
    alignas(16) T e[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xr + base);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = xr[base + i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = to_f32(e[i]) * r;
      e[i] = from_f32<T>(y * (1.f + w[base + i]));
    }
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(orow + base) = *reinterpret_cast<const uint4*>(e);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) orow[base + i] = e[i];
    }
  }
}

template <typename T, int TPR>
cudaError_t launch_rows(const T* x, const float* w, T* out, int n, int d,
                        float eps, cudaStream_t stream) {
  constexpr int kRows = kBlock / TPR;
  return launch_dependent(rmsnorm_kernel<T, TPR>, dim3((n + kRows - 1) / kRows),
                          dim3(kBlock), 0, stream, x, w, out, n, d, eps);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int n, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  if (vec && d > 32 * kMaxElems && d <= 64 * kMaxElems)
    return launch_rows<T, 64>(xp, wp, op, n, d, eps, stream);
  if (vec && d > 64 * kMaxElems && d <= 128 * kMaxElems)
    return launch_rows<T, 128>(xp, wp, op, n, d, eps, stream);
  if (vec)
    return launch_dependent(rmsnorm_loop_kernel<T, kVec>, dim3(n),
                            dim3(kBlock), 0, stream, xp, wp, op, d, eps);
  return launch_dependent(rmsnorm_loop_kernel<T, 1>, dim3(n), dim3(kBlock),
                          0, stream, xp, wp, op, d, eps);
}

constexpr int kBwdBlocks = 264;  // most blocks of the backward's row pass
                                 // (BWD_BLOCKS in kernels/fused_rmsnorm.py)
constexpr int kBwdVecs = 4;      // 16-byte vectors of x, and of dy, a thread
constexpr int kLoopRows = 16;    // rows at a time of the looping path
constexpr int kDwCols = 32;      // columns a block of the dw pass

template <typename T, int TPR>
__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int n, int d,
                        int rows_per_block, float eps) {
  constexpr int kVec = 16 / sizeof(T);       // elements a 16-byte vector
  constexpr int kNV = kBwdVecs;              // vectors a thread
  constexpr int kWPR = TPR / 32;             // warps a row
  constexpr int kRows = kBlock / TPR;        // rows a pass
  // columns a row group covers, kept in shared memory to sum the groups
  constexpr int kCols = kRows > 1 ? TPR * kNV * kVec : 4;
  __shared__ float red[2][kRows][kWPR][2];
  __shared__ __align__(16) float sums[kRows][kCols];
  const int rib = threadIdx.x / TPR;         // row group in the block
  const int t = threadIdx.x % TPR;
  const int nvec = d / kVec;
  const int start = blockIdx.x * rows_per_block;
  const int end = min(start + rows_per_block, n);
  const int n_pass = (end - start + kRows - 1) / kRows;

  // the kernel before this one may write x, w or dy
  wait_previous_grid();
  float wc[kNV][kVec], acc[kNV][kVec];
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int v = t + i * TPR;
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      const float4 w4 = v < nvec
          ? reinterpret_cast<const float4*>(w)[v * (kVec / 4) + j]
          : make_float4(0.f, 0.f, 0.f, 0.f);
      wc[i][4 * j] = 1.f + w4.x;
      wc[i][4 * j + 1] = 1.f + w4.y;
      wc[i][4 * j + 2] = 1.f + w4.z;
      wc[i][4 * j + 3] = 1.f + w4.w;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < n_pass; ++it) {
    const int row = start + it * kRows + rib;
    const bool live = row < end;
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + static_cast<size_t>(row) * d);
    uint4 xv[kNV], gv[kNV];
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int v = t + i * TPR;
      const bool ok = live && v < nvec;
      xv[i] = ok ? xr[v] : make_uint4(0u, 0u, 0u, 0u);
      gv[i] = ok ? gr[v] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      float f[kVec], g[kVec];
      unpack16(xv[i], f);
      unpack16(gv[i], g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ss += f[e] * f[e];
        dot += g[e] * wc[i][e] * f[e];
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if ((t & 31) == 0) {
      red[it & 1][rib][t >> 5][0] = ss;
      red[it & 1][rib][t >> 5][1] = dot;
    }
    __syncthreads();
    ss = dot = 0.f;
#pragma unroll
    for (int k = 0; k < kWPR; ++k) {
      ss += red[it & 1][rib][k][0];
      dot += red[it & 1][rib][k][1];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = dot * r * r * r / static_cast<float>(d);
    uint4* dxr = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * d);
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int v = t + i * TPR;
      if (!live || v >= nvec) continue;
      float f[kVec], g[kVec];
      unpack16(xv[i], f);
      unpack16(gv[i], g);
      alignas(16) T e[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        e[k] = from_f32<T>(r * wc[i][k] * g[k] - f[k] * coef);
        acc[i][k] += g[k] * f[k] * r;
      }
      dxr[v] = *reinterpret_cast<const uint4*>(e);
    }
  }

  // the block's partial row: its row groups summed in group order
  float* prow = partial + static_cast<size_t>(blockIdx.x) * d;
  if constexpr (kRows == 1) {
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int v = t + i * TPR;
      if (v >= nvec) continue;
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j)
        reinterpret_cast<float4*>(prow + v * kVec)[j] =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int v = t + i * TPR;
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      reinterpret_cast<float4*>(&sums[rib][v * kVec])[j] =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                      acc[i][4 * j + 3]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kBlock) {
    float s = sums[0][c];
#pragma unroll
    for (int k = 1; k < kRows; ++k) s += sums[k][c];
    prow[c] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_loop_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int n, int d,
                        int rows_per_block, float eps) {
  __shared__ float red[2][kBlock / 32];
  __shared__ float r_s[kLoopRows], coef_s[kLoopRows];
  const int start = blockIdx.x * rows_per_block;
  const int end = min(start + rows_per_block, n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* prow = partial + static_cast<size_t>(blockIdx.x) * d;
  wait_previous_grid();
  for (int r0 = start; r0 < end; r0 += kLoopRows) {
    const int rows = min(kLoopRows, end - r0);
    for (int rr = 0; rr < rows; ++rr) {
      const T* xr = x + static_cast<size_t>(r0 + rr) * d;
      const T* gr = dy + static_cast<size_t>(r0 + rr) * d;
      float ss = 0.f, dot = 0.f;
      for (int c = tid; c < d; c += kBlock) {
        const float xv = to_f32(xr[c]);
        ss += xv * xv;
        dot += to_f32(gr[c]) * (1.f + w[c]) * xv;
      }
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      if (lane == 0) {
        red[0][warp] = ss;
        red[1][warp] = dot;
      }
      __syncthreads();
      if (tid == 0) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int k = 0; k < kBlock / 32; ++k) {
          a += red[0][k];
          b += red[1][k];
        }
        const float r = rsqrtf(a / static_cast<float>(d) + eps);
        r_s[rr] = r;
        coef_s[rr] = b * r * r * r / static_cast<float>(d);
      }
      __syncthreads();
    }
    for (int c = tid; c < d; c += kBlock) {
      const float wc = 1.f + w[c];
      float acc = r0 == start ? 0.f : prow[c];
      for (int rr = 0; rr < rows; ++rr) {
        const size_t off = static_cast<size_t>(r0 + rr) * d + c;
        const float xv = to_f32(x[off]), g = to_f32(dy[off]);
        const float r = r_s[rr];
        dx[off] = from_f32<T>(r * wc * g - xv * coef_s[rr]);
        acc += g * xv * r;
      }
      prow[c] = acc;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_dw_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int blocks, int d) {
  constexpr int kWarps = kBlock / 32;
  __shared__ float red[kWarps][kDwCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kDwCols + lane;
  wait_previous_grid();                // the partials of the row pass
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kWarps)
      s += partial[static_cast<size_t>(b) * d + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += red[k][lane];
    dw[c] = total;
  }
}

template <typename T, int TPR>
cudaError_t launch_bwd_rows(const T* x, const float* w, const T* dy, T* dx,
                            float* partial, int n, int d, int rows,
                            int blocks, float eps, cudaStream_t stream) {
  return launch_dependent(rmsnorm_bwd_rows_kernel<T, TPR>, dim3(blocks),
                          dim3(kBlock), 0, stream, x, w, dy, dx, partial, n,
                          d, rows, eps);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, void* partial, int n, int d, float eps,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerThread = kBwdVecs * kVec;  // columns a thread
  const int rows = (n + kBwdBlocks - 1) / kBwdBlocks;  // rows a block
  const int blocks = (n + rows - 1) / rows;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  const float* wp = static_cast<const float*>(w);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(dy) && aligned16(dx);
  cudaError_t e;
  if (vec && d <= 32 * kPerThread)
    e = launch_bwd_rows<T, 32>(xp, wp, gp, dxp, pp, n, d, rows, blocks, eps, stream);
  else if (vec && d <= 64 * kPerThread)
    e = launch_bwd_rows<T, 64>(xp, wp, gp, dxp, pp, n, d, rows, blocks, eps, stream);
  else if (vec && d <= 128 * kPerThread)
    e = launch_bwd_rows<T, 128>(xp, wp, gp, dxp, pp, n, d, rows, blocks, eps, stream);
  else if (vec && d <= 256 * kPerThread)
    e = launch_bwd_rows<T, 256>(xp, wp, gp, dxp, pp, n, d, rows, blocks, eps, stream);
  else
    e = launch_dependent(rmsnorm_bwd_loop_kernel<T>, dim3(blocks),
                         dim3(kBlock), 0, stream, xp, wp, gp, dxp, pp, n, d,
                         rows, eps);
  if (e != cudaSuccess) return e;
  return launch_dependent(rmsnorm_bwd_dw_kernel,
                          dim3((d + kDwCols - 1) / kDwCols), dim3(kBlock), 0,
                          stream, static_cast<const float*>(partial),
                          static_cast<float*>(dw), blocks, d);
}

}  // namespace
}  // namespace repro

// partial: (kBwdBlocks, d) f32 scratch from the wrapper (BWD_BLOCKS in
// kernels/fused_rmsnorm.py); the row pass fills its first
// ceil(n / ceil(n / kBwdBlocks)) rows
extern "C" int repro_fused_rmsnorm_bwd(const void* x, const void* w,
                                       const void* dy, void* dx, void* dw,
                                       void* partial, int n, int d,
                                       float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == repro::kBF16) {
    e = repro::launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, partial, n, d, eps,
                                         s);
  } else if (dtype == repro::kF32) {
    e = repro::launch_bwd<float>(x, w, dy, dx, dw, partial, n, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fused_rmsnorm(const void* x, const void* w, void* out,
                                   int n, int d, float eps, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == repro::kBF16) {
    e = repro::launch<__nv_bfloat16>(x, w, out, n, d, eps, s);
  } else if (dtype == repro::kF32) {
    e = repro::launch<float>(x, w, out, n, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
