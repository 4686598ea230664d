// Shared helpers of the port's CUDA kernels: dtype codes, f32 conversion,
// warp reductions, the asynchronous copies, ldmatrix loads and bf16
// mma.sync of the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu), the TF32 mma.sync of the ssm kernels
// (ssm_scan.cu, ssm_scan_bwd.cu), and the fixed-order sum of partials of the
// scans' backward kernels (ssm_scan_bwd.cu, rwkv6_scan_bwd.cu). Every kernel computes in f32 and reads/writes
// bf16 or f32 tensors; the dtype code is what the Python wrappers pass.
// A source that keeps its own copy of a helper under the same name
// (ssm_scan.cu, rwkv6_scan.cu) declares it in its anonymous namespace,
// where it hides this one.
#pragma once

#include <cstdint>

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

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
// (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// 4-byte global -> shared copy, zero-filled when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8 TF32, row) * b (8x8 TF32, col), f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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

namespace {

// Sums partial results in a fixed order, with no atomics, so that two
// calls give the same bits: out[g * E + e] = the sum over m = 0, 1, ..
// M - 1, in that order, of part[g * sg + m * sm + e], cast to Tout, for
// g < G and e < E; a thread an element, neighbours on neighbouring e.
// The scans' backward kernels write a partial a head (ssm_scan_bwd.cu:
// dB and dC, summed over the heads of a B/C group; rwkv6_scan_bwd.cu:
// du, over the heads that share a row of u) or a block of rows
// (rwkv6_scan_bwd.cu: dv). In an anonymous namespace: each source that
// launches it compiles its own instance.
template <typename Tout>
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ part, Tout* __restrict__ out,
                    long long G, long long E, int M, long long sg,
                    long long sm) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= G * E) return;
  const long long g = idx / E, e = idx % E;
  const float* p = part + g * sg + e;
  float acc = 0.f;
  for (int m = 0; m < M; ++m) acc += p[m * sm];
  out[idx] = from_f32<Tout>(acc);
}

template <typename Tout>
void sum_partials(const float* part, Tout* out, long long G, long long E,
                  int M, long long sg, long long sm, cudaStream_t stream) {
  const long long n = G * E;
  if (n <= 0) return;
  sum_partials_kernel<Tout><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                              stream>>>(part, out, G, E, M, sg, sm);
}

}  // namespace
}  // namespace repro
