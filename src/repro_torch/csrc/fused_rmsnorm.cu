// fused_rmsnorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), in f32, cast to
// x's dtype. x (N, d) bf16 or f32 row-major, w (d,) f32.
//
// Replaces the Pallas TPU kernel fused_rmsnorm / _rmsnorm_kernel
// (src/repro/kernels/fused_rmsnorm.py:19, body :11), which pads N to a
// tile of rows and normalises a (rows, d) block per grid step.
//
// Bound on an H100: bytes. Each element is read once and written once
// with ~4 flops, far below the card's ~295 flops/byte balance, so the
// least time is (2 * N * d * sizeof(T) + 4 * d) / 3.35 TB/s.
//
// Design: one block of 256 threads per row, so no padding and any N.
// The row is read with 16-byte vector loads where d allows (8 bf16 or 4
// f32 per load), squared and summed in f32 per thread, reduced by warp
// shuffles and a fixed-order pass over the 8 warp partials (deterministic),
// then read again (from L1/L2, the row is at most a few KB) to scale and
// store. At decode (N = 1) the kernel is launch-latency bound.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int base = threadIdx.x * VEC; base < d; base += kThreads * VEC) {
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
  __shared__ float partial[kThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  for (int base = threadIdx.x * VEC; base < d; base += kThreads * VEC) {
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

template <typename T>
void launch(const void* x, const void* w, void* out, int n, int d, float eps,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  if (d % kVec == 0) {
    rmsnorm_kernel<T, kVec><<<n, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<n, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_fused_rmsnorm(const void* x, const void* w, void* out,
                                   int n, int d, float eps, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) {
    repro::launch<__nv_bfloat16>(x, w, out, n, d, eps, s);
  } else if (dtype == repro::kF32) {
    repro::launch<float>(x, w, out, n, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
