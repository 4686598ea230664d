// flash_attention: blocked online-softmax attention for prefill.
// q (BH, Sq, hd), k/v (BH_kv, Sk, hd), out (BH, Sq, hd); bf16 or f32.
// Row bh of q attends to row bh / (BH / BH_kv) of k and v (GQA indexing;
// BH == BH_kv for multi-head attention).
//
// Replaces the Pallas TPU kernel flash_attention / _flash_kernel
// (src/repro/kernels/flash_attention.py:77, body :26). Same arithmetic:
// q pre-scaled by 1/sqrt(hd) in f32, f32 running max m, sum l and
// accumulator, masked scores set to -1e30, l clamped at 1e-30, causal
// mask on absolute indices from 0 (k <= q), optional window (k > q - W),
// keys past Sk masked. On the TPU the k-block axis is a sequential grid
// axis carrying m/l/acc in VMEM scratch; here the k loop runs inside the
// block and m/l/acc live in registers.
//
// Bound on an H100: bytes at the serving path's shapes. Per (bh, q, k)
// pair that survives the causal mask it does 4 * hd flops (Q K^T and P V),
// against 4 * BH * S * hd * sizeof(T) bytes for q, k, v and out: at
// S = 513, hd = 128 that is ~130 flops/byte, below the card's ~295
// flops/byte bf16 balance. This first kernel does not reach either bound:
// it runs both products on the f32 FMA units (no tensor cores) and at
// hd = 128 needs ~170 registers a thread, so one 256-thread block fits on
// an SM. mma/wgmma on bf16 tiles is the later step.
//
// Design: one block per (64-row q tile, bh); 4 threads per q row, each
// owning hd/4 of the head dims as float4 chunks interleaved so that the 4
// threads of a row read 64 contiguous bytes of shared memory while the 8
// rows of a warp read the same addresses (broadcast, conflict-free).
// K and V tiles of 32 keys are staged in shared memory as f32 (32 KB at
// hd = 128). Scores of a tile are reduced across the 4 threads with two
// shuffles and kept in registers, so the online-softmax rescale happens
// once per tile. Key tiles wholly in the future (causal) or wholly left of
// the window are never loaded. Ragged Sq and Sk are masked in the kernel.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;                 // q rows per block
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kTPR = 4;                 // threads per q row
constexpr int kThreads = kBQ * kTPR;    // 256

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int sq,
             int sk, int causal, int window, float scale) {
  constexpr int kDPT = HD / kTPR;       // head dims per thread
  constexpr int kNV4 = kDPT / 4;        // float4 chunks per thread
  static_assert(kDPT % 4 == 0, "hd must be a multiple of 16");
  __shared__ float4 ks[kBK][HD / 4];
  __shared__ float4 vs[kBK][HD / 4];

  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int sub = tid % kTPR;
  const int qi = q0 + r;
  const bool q_valid = qi < sq;

  // chunk c of this thread covers dims 4 * (sub + kTPR * c) .. + 3
  float qf[kDPT];
  float acc[kDPT];
  const T* qrow = q + (static_cast<size_t>(bh) * sq + (q_valid ? qi : 0)) * HD;
#pragma unroll
  for (int c = 0; c < kNV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (sub + kTPR * c) + e;
      qf[4 * c + e] = q_valid ? to_f32(qrow[dim]) * scale : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  const T* kbase = k + static_cast<size_t>(kvh) * sk * HD;
  const T* vbase = v + static_cast<size_t>(kvh) * sk * HD;
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD;
      const int kk = kt + j;
      float kv = 0.f, vv = 0.f;
      if (kk < sk) {
        const size_t off = static_cast<size_t>(kk) * HD + (e % HD);
        kv = to_f32(kbase[off]);
        vv = to_f32(vbase[off]);
      }
      ksf[e] = kv;
      vsf[e] = vv;
    }
    __syncthreads();

    float s[kBK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kNV4; ++c) {
        const float4 kv4 = ks[j][sub + kTPR * c];
        part += qf[4 * c] * kv4.x + qf[4 * c + 1] * kv4.y +
                qf[4 * c + 2] * kv4.z + qf[4 * c + 3] * kv4.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kk = kt + j;
      bool ok = kk < sk;
      if (causal) ok = ok && kk <= qi;
      if (window > 0) ok = ok && kk > qi - window;
      s[j] = ok ? part : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < kNV4; ++c) {
        const float4 v4 = vs[j][sub + kTPR * c];
        acc[4 * c] += p * v4.x;
        acc[4 * c + 1] += p * v4.y;
        acc[4 * c + 2] += p * v4.z;
        acc[4 * c + 3] += p * v4.w;
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * sq + qi) * HD;
#pragma unroll
    for (int c = 0; c < kNV4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[4 * (sub + kTPR * c) + e] = from_f32<T>(acc[4 * c + e] / denom);
      }
    }
  }
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v, void* o, int bh,
               int group, int sq, int sk, int causal, int window,
               cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  flash_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, sk, causal,
      window, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int sk, int hd, int causal, int window,
           cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, 16>(q, k, v, o, bh, group, sq, sk, causal, window, stream); break;
    case 32: launch_hd<T, 32>(q, k, v, o, bh, group, sq, sk, causal, window, stream); break;
    case 64: launch_hd<T, 64>(q, k, v, o, bh, group, sq, sk, causal, window, stream); break;
    case 128: launch_hd<T, 128>(q, k, v, o, bh, group, sq, sk, causal, window, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh,
                                     int bh_kv, int sq, int sk, int hd,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bh_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(q, k, v, o, bh, group, sq, sk, hd, causal, window, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(q, k, v, o, bh, group, sq, sk, hd, causal, window, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
