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
// Bound: bytes (x and dy read, dx written; the dw partials are 4 d bytes
// a block). rmsnorm_bwd_rows_kernel takes kBwdRows rows a block of 256
// threads, any d: a first loop over each row's columns sums x^2 and g x
// (warp shuffles, then the 8 warps in a fixed order) into r and the
// row's coefficient; a second loop over the columns writes dx and the
// block's partial of dw, its rows summed in order. rmsnorm_bwd_dw_kernel
// then sums the partials of every block, a thread a column, in groups of
// 32 blocks and then the groups in order. No float atomics: two runs give
// the same bits.
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

constexpr int kBwdRows = 16;  // rows a block of the backward's first pass
                              // (BWD_ROWS in kernels/fused_rmsnorm.py)

template <typename T>
__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int n, int d,
                        float eps) {
  __shared__ float red[2][kBlock / 32];
  __shared__ float r_s[kBwdRows], coef_s[kBwdRows];
  const size_t r0 = static_cast<size_t>(blockIdx.x) * kBwdRows;
  const int rows = min(static_cast<size_t>(kBwdRows), n - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int rr = 0; rr < rows; ++rr) {
    const T* xr = x + (r0 + rr) * d;
    const T* gr = dy + (r0 + rr) * d;
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
    float acc = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const size_t off = (r0 + rr) * d + c;
      const float xv = to_f32(x[off]), g = to_f32(dy[off]);
      const float r = r_s[rr];
      dx[off] = from_f32<T>(r * wc * g - xv * coef_s[rr]);
      acc += g * xv * r;
    }
    partial[static_cast<size_t>(blockIdx.x) * d + c] = acc;
  }
}

__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_dw_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int blocks, int d) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= d) return;
  // groups of 32 partials summed, then the groups' sums: a fixed order
  // that rounds as ~32 + blocks / 32 additions, not blocks
  float acc = 0.f;
  for (int b0 = 0; b0 < blocks; b0 += 32) {
    float s = 0.f;
    for (int b = b0; b < min(b0 + 32, blocks); ++b)
      s += partial[static_cast<size_t>(b) * d + c];
    acc += s;
  }
  dw[c] = acc;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, void* partial, int n, int d, float eps,
                       cudaStream_t stream) {
  const int blocks = (n + kBwdRows - 1) / kBwdRows;
  rmsnorm_bwd_rows_kernel<T><<<blocks, kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), n, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_dw_kernel<<<(d + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), blocks, d);
  return cudaSuccess;
}

}  // namespace
}  // namespace repro

// partial: (ceil(n / kBwdRows), d) f32 scratch from the wrapper
// (kernels/fused_rmsnorm.py's BWD_ROWS)
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
