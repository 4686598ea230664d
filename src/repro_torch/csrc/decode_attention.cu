// decode_attention: single-query attention over a KV cache (flash-decode).
// q (BH, 1, hd), k/v (BH_kv, S, hd) caches, lengths (BH,) int32, out
// (BH, 1, hd); bf16 or f32. Row bh attends to keys 0 .. lengths[bh] - 1
// (and, with a window W, only keys > lengths[bh] - 1 - W) of cache row
// bh / (BH / BH_kv).
//
// Replaces the Pallas TPU kernel decode_attention / _decode_kernel
// (src/repro/kernels/decode_attention.py:57, body :22): q pre-scaled by
// 1/sqrt(hd) in f32, f32 partial softmax state, output divided by
// max(l, 1e-30). The Pallas kernel walks every cache block and masks;
// this one walks only the live prefix. Lengths must be >= 1 (the serving
// path always has one): at 0 this kernel writes zeros where the Pallas
// kernel averages V over the padded cache.
//
// Bound on an H100: bytes. Each live cache entry is read once with 2 * hd
// flops per K row and per V row, about 1 flop per byte in bf16, so the
// least time is 2 * sum(lengths) * hd * sizeof(T) / 3.35 TB/s.
//
// Design: one block of 8 warps per bh. Warp w takes 4 consecutive keys
// at a time, strided by 32 keys across the warps, so each warp keeps 4
// rows of loads in flight; lanes split hd (lane, lane + 32, ...), so a K
// or V row is one coalesced read. Each warp keeps its own m, l and
// accumulator; the 8 partial states are merged in shared memory at the
// end. With BH = 32 blocks on 132 SMs the card is under-filled at batch 1;
// a split-K pass over the cache is the later fix.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKPW = 4;  // keys per warp step

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int group, int S, int window, float scale) {
  constexpr int kDPL = (HD + 31) / 32;  // head dims per lane
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];

  const int bh = blockIdx.x;
  const int kvh = bh / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(lengths[bh], S);
  const int begin = window > 0 ? max(0, len - window) : 0;
  const T* kb = k + static_cast<size_t>(kvh) * S * HD;
  const T* vb = v + static_cast<size_t>(kvh) * S * HD;

  float qf[kDPL];
  float acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int dim = lane + 32 * i;
    qf[i] = dim < HD ? to_f32(q[static_cast<size_t>(bh) * HD + dim]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int j0 = begin + warp * kKPW; j0 < len; j0 += kWarps * kKPW) {
    float s[kKPW];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kKPW; ++u) {
      const int j = j0 + u;
      float part = 0.f;
      if (j < len) {
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int dim = lane + 32 * i;
          if (dim < HD) part += qf[i] * to_f32(kb[static_cast<size_t>(j) * HD + dim]);
        }
      }
      part = warp_sum(part);
      s[u] = j < len ? part : kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kKPW; ++u) {
      const int j = j0 + u;
      if (j < len) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int dim = lane + 32 * i;
          if (dim < HD) acc[i] += p * to_f32(vb[static_cast<size_t>(j) * HD + dim]);
        }
      }
    }
    m = m_new;
  }

#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int dim = lane + 32 * i;
    if (dim < HD) sm_acc[warp][dim] = acc[i];
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();
  for (int dim = threadIdx.x; dim < HD; dim += kThreads) {
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mt);
      lt += sm_l[w] * f;
      at += sm_acc[w][dim] * f;
    }
    o[static_cast<size_t>(bh) * HD + dim] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v,
               const int* lengths, void* o, int bh, int group, int S,
               int window, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  decode_kernel<T, HD><<<bh, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), group, S,
      window, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int bh, int group, int S, int hd, int window,
           cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, 16>(q, k, v, lengths, o, bh, group, S, window, stream); break;
    case 32: launch_hd<T, 32>(q, k, v, lengths, o, bh, group, S, window, stream); break;
    case 64: launch_hd<T, 64>(q, k, v, lengths, o, bh, group, S, window, stream); break;
    case 128: launch_hd<T, 128>(q, k, v, lengths, o, bh, group, S, window, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* o, int bh, int bh_kv, int S,
                                      int hd, int window, int dtype,
                                      void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bh_kv;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(q, k, v, lens, o, bh, group, S, hd, window, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(q, k, v, lens, o, bh, group, S, hd, window, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
