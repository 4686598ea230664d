// Shared helpers of the port's CUDA kernels: dtype codes, f32 conversion,
// warp reductions. Every kernel computes in f32 and reads/writes bf16 or
// f32 tensors; the dtype code is what the Python wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1 };

// The masked-score value of the Pallas kernels (NEG_INF = -1e30): a
// finite number, so exp(m_prev - m_new) stays defined on masked rows.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro
