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

// Waits until the grids launched before this one on the stream have
// finished and their writes are visible (a no-op without a programmatic
// dependent launch). Everything before it overlaps the previous kernel.
__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launches `kernel` as a programmatic dependent launch: its blocks may be
// scheduled while the previous kernel on the stream still runs, and must
// call wait_previous_grid() before reading anything that kernel writes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace repro
