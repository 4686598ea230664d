// flash_attention backward: the gradients of flash_attention.cu's
// function (scores scaled by 1/sqrt(hd), causal from index 0, optional
// window k > q - W, GQA), FA2's recomputation scheme. No softcap (the
// wrapper refuses a gradient through a capped call).
// q, dq (BH, Sq, hd); k, v, dk, dv (BH_kv, Sk, hd); o, dO (BH, Sq, hd);
// lse, D (BH, Sq) f32. bf16 or f32 inputs and outputs, f32 arithmetic.
//
// Replaces the gradient of the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:77). The JAX package has no
// backward kernel: its model trains through XLA's autodiff of
// flash_attention_xla (src/repro/models/layers.py:138), which these
// kernels compute for the kernel's function.
//
//   D_i   = sum_d dO_id O_id                      (flash_bwd_preprocess)
//   P_ij  = exp(scale q_i.k_j - lse_i), 0 where masked
//   dP_ij = dO_i.v_j,  dS_ij = P_ij (dP_ij - D_i)
//   dV_j  = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i   (flash_bwd_dkdv)
//   dQ_i  = scale sum_j dS_ij k_j                            (flash_bwd_dq)
//
// lse comes from the forward (its natural log-sum-exp), so P is
// recomputed without a second pass over the keys.
//
// Bound on an H100: operations. Per unmasked (q, k) pair the two kernels
// do 14 hd flops (dkdv: Q K^T, dO V^T, P^T dO, dS^T Q; dq: Q K^T,
// dO V^T, dS K), 3.5x the forward's 4 hd; at the training shape (BH 64,
// S 4096, hd 128, causal) that is ~960 GFLOP against ~0.3 GB of inputs
// and outputs.
//
// Design: the simple SIMT form, every product an f32 FMA on the CUDA
// cores (tensor cores, TMA and wgmma are later work). Tiles of 32 query
// rows and 32 keys are held in shared memory as f32 rows of hd + 1
// floats (an odd stride: the column loads of a warp fall in distinct
// banks), with the 32 x 32 tiles of P and dS beside them. 256 threads:
// in the score phase thread (ty, tx) computes the four entries (ty +
// 16a, tx + 16b) of S and dP; in the product phase a row of the output
// tile belongs to 8 threads, thread c of them owning columns c, c + 8, ...
// (hd / 8 f32 accumulators each for dK and dV, or for dQ).
//
// No float atomics: dK and dV of a key tile are summed by the one block
// that owns it, over the G query heads of its KV head (GQA, in head
// order) and the query tiles in order; dQ of a query tile by the one
// block that owns it, over the key tiles in order. Every sum has a fixed
// order, so two runs give the same bits. Tiles wholly outside the causal
// or window band are skipped; a tile on an edge masks per element.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kB = 32;            // query rows, and keys, a tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kCols = 8;          // threads sharing an output row

template <int HD>
struct BwdLayout {
  static constexpr int kS = HD + 1;     // f32 a smem row of Q, dO, K, V
  static constexpr int kP = kB + 1;     // f32 a smem row of P, dS
  static constexpr int kDPT = HD / kCols;  // output columns a thread
  // Q, dO, K, V tiles, P and dS, lse and D of the query rows
  static constexpr int kBytes = (4 * kB * kS + 2 * kB * kP + 2 * kB) * 4;
  static_assert(HD % kCols == 0, "hd must be a multiple of 8");
};

// rows row0 .. row0 + kB - 1 of a (nrows, HD) matrix into a (kB, HD + 1)
// f32 tile; rows past nrows are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int nrows) {
  for (int e = threadIdx.x; e < kB * HD; e += kThreads) {
    const int r = e / HD, c = e - r * HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + c] =
        row < nrows ? to_f32(src[static_cast<size_t>(row) * HD + c]) : 0.f;
  }
}

// the tile pair (query rows q0.., keys k0..): P and dS = P (dP - D) into
// ps and dss (kB x kB, row = query)
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse_s, const float* d_s,
                                       float* ps, float* dss, int q0, int k0,
                                       int sq, int sk, int causal, int window,
                                       float scale) {
  constexpr int kS = BwdLayout<HD>::kS;
  constexpr int kP = BwdLayout<HD>::kP;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float qa[2] = {qs[ty * kS + d], qs[(ty + 16) * kS + d]};
    const float oa[2] = {dos[ty * kS + d], dos[(ty + 16) * kS + d]};
    const float kb[2] = {ks[tx * kS + d], ks[(tx + 16) * kS + d]};
    const float vb[2] = {vs[tx * kS + d], vs[(tx + 16) * kS + d]};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        s[a][b] += qa[a] * kb[b];
        dp[a][b] += oa[a] * vb[b];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      const int qi = q0 + i, key = k0 + j;
      bool ok = qi < sq && key < sk;
      if (causal) ok = ok && key <= qi;
      if (window > 0) ok = ok && key > qi - window;
      const float p = ok ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
      ps[i * kP + j] = p;
      dss[i * kP + j] = p * (dp[a][b] - d_s[i]);
    }
  }
}

// lse and D of query rows q0.. (0 past sq)
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const float* lse, const float* delta,
                                          size_t base, int q0, int sq) {
  if (threadIdx.x < kB) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < sq ? lse[base + r] : 0.f;
    d_s[threadIdx.x] = r < sq ? delta[base + r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ o,
                            const T* __restrict__ dout,
                            float* __restrict__ delta, int rows, int hd) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32) +
                     threadIdx.x / 32;
  if (row >= static_cast<size_t>(rows)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc += to_f32(o[row * hd + d]) * to_f32(dout[row * hd + d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// grid (key tiles, BH_kv)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int group, int sq, int sk,
                      int causal, int window, float scale) {
  using L = BwdLayout<HD>;
  constexpr int kS = L::kS, kP = L::kP, kDPT = L::kDPT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kB * kS;
  float* qs = vs + kB * kS;
  float* dos = qs + kB * kS;
  float* ps = dos + kB * kS;
  float* dss = ps + kB * kP;
  float* lse_s = dss + kB * kP;
  float* d_s = lse_s + kB;

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  load_tile<T, HD>(ks, k + static_cast<size_t>(kvh) * sk * HD, k0, sk);
  load_tile<T, HD>(vs, v + static_cast<size_t>(kvh) * sk * HD, k0, sk);
  // query rows that see a key of this tile: q >= k0 (causal) and
  // q < k_max + W (window)
  const int k_max = min(k0 + kB, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_max + window) : sq;

  const int j = threadIdx.x / kCols;   // this thread's key row
  const int c0 = threadIdx.x % kCols;  // its first column
  float dk_acc[kDPT], dv_acc[kDPT];
#pragma unroll
  for (int c = 0; c < kDPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const size_t bh = static_cast<size_t>(kvh) * group + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += kB) {
      __syncthreads();                 // the previous tile is consumed
      load_tile<T, HD>(qs, q + bh * sq * HD, q0, sq);
      load_tile<T, HD>(dos, dout + bh * sq * HD, q0, sq);
      load_rows(lse_s, d_s, lse, delta, bh * sq, q0, sq);
      __syncthreads();
      scores<HD>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, sq, sk,
                 causal, window, scale);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kB; ++i) {
        const float p = ps[i * kP + j], ds = dss[i * kP + j];
#pragma unroll
        for (int c = 0; c < kDPT; ++c) {
          const int d = c0 + kCols * c;
          dv_acc[c] += p * dos[i * kS + d];
          dk_acc[c] += ds * qs[i * kS + d];
        }
      }
    }
  }
  const int key = k0 + j;
  if (key < sk) {
    const size_t off = (static_cast<size_t>(kvh) * sk + key) * HD;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) {
      const int d = c0 + kCols * c;
      dk[off + d] = from_f32<T>(dk_acc[c] * scale);
      dv[off + d] = from_f32<T>(dv_acc[c]);
    }
  }
}

// grid (query tiles, BH)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int group, int sq, int sk, int causal, int window,
                    float scale) {
  using L = BwdLayout<HD>;
  constexpr int kS = L::kS, kP = L::kP, kDPT = L::kDPT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kB * kS;
  float* qs = vs + kB * kS;
  float* dos = qs + kB * kS;
  float* ps = dos + kB * kS;
  float* dss = ps + kB * kP;
  float* lse_s = dss + kB * kP;
  float* d_s = lse_s + kB;

  const size_t bh = blockIdx.y;
  const size_t kvh = bh / group;
  const int q0 = blockIdx.x * kB;
  load_tile<T, HD>(qs, q + bh * sq * HD, q0, sq);
  load_tile<T, HD>(dos, dout + bh * sq * HD, q0, sq);
  load_rows(lse_s, d_s, lse, delta, bh * sq, q0, sq);
  // keys this tile's rows see: k <= q_last (causal), k > q0 - W (window)
  const int q_last = min(q0 + kB, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kB * kB : 0;

  const int i = threadIdx.x / kCols;   // this thread's query row
  const int c0 = threadIdx.x % kCols;
  float acc[kDPT];
#pragma unroll
  for (int c = 0; c < kDPT; ++c) acc[c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kB) {
    __syncthreads();                   // the previous K/V and dS are consumed
    load_tile<T, HD>(ks, k + kvh * sk * HD, k0, sk);
    load_tile<T, HD>(vs, v + kvh * sk * HD, k0, sk);
    __syncthreads();
    scores<HD>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, sq, sk, causal,
               window, scale);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      const float ds = dss[i * kP + j];
#pragma unroll
      for (int c = 0; c < kDPT; ++c)
        acc[c] += ds * ks[j * kS + c0 + kCols * c];
    }
  }
  if (q0 + i < sq) {
    T* row = dq + (bh * sq + q0 + i) * HD;
#pragma unroll
    for (int c = 0; c < kDPT; ++c)
      row[c0 + kCols * c] = from_f32<T>(acc[c] * scale);
  }
}

template <typename T, int HD>
int launch_grads(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int bh, int group, int sq,
                 int sk, int causal, int window, cudaStream_t stream) {
  constexpr int kBytes = BwdLayout<HD>::kBytes;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  if (dk != nullptr) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((sk + kB - 1) / kB, bh / group);
    flash_bwd_dkdv_kernel<T, HD><<<grid, kThreads, kBytes, stream>>>(
        qp, kp, vp, dp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        group, sq, sk, causal, window, scale);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((sq + kB - 1) / kB, bh);
    flash_bwd_dq_kernel<T, HD><<<grid, kThreads, kBytes, stream>>>(
        qp, kp, vp, dp, lse, delta, static_cast<T*>(dq), group, sq, sk,
        causal, window, scale);
  }
  return 0;
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, void* dk, void* dv, int bh, int group, int sq,
              int sk, int causal, int window, cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_grads<__nv_bfloat16, HD>(q, k, v, dout, lse, delta, dq, dk,
                                           dv, bh, group, sq, sk, causal,
                                           window, stream);
  if (dtype == kF32)
    return launch_grads<float, HD>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                   group, sq, sk, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk and dv non-null: the dK/dV kernel; else the dQ kernel into dq
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int bh_kv, int sq, int sk, int hd, int causal, int window,
           int dtype, void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bh_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  int rc;
  switch (hd) {
    case 16: rc = launch_hd<16>(dtype, q, k, v, dout, l, dl, dq, dk, dv, bh, group, sq, sk, causal, window, s); break;
    case 32: rc = launch_hd<32>(dtype, q, k, v, dout, l, dl, dq, dk, dv, bh, group, sq, sk, causal, window, s); break;
    case 64: rc = launch_hd<64>(dtype, q, k, v, dout, l, dl, dq, dk, dv, bh, group, sq, sk, causal, window, s); break;
    case 128: rc = launch_hd<128>(dtype, q, k, v, dout, l, dl, dq, dk, dv, bh, group, sq, sk, causal, window, s); break;
    case 168: rc = launch_hd<168>(dtype, q, k, v, dout, l, dl, dq, dk, dv, bh, group, sq, sk, causal, window, s); break;
    case 240: rc = launch_hd<240>(dtype, q, k, v, dout, l, dl, dq, dk, dv, bh, group, sq, sk, causal, window, s); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_bwd_preprocess(const void* o, const void* dout,
                                          void* delta, int rows, int hd,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + repro::kThreads / 32 - 1) / (repro::kThreads / 32));
  float* d = static_cast<float*>(delta);
  if (dtype == repro::kBF16) {
    repro::flash_bwd_preprocess_kernel<__nv_bfloat16>
        <<<grid, repro::kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(o),
            static_cast<const __nv_bfloat16*>(dout), d, rows, hd);
  } else if (dtype == repro::kF32) {
    repro::flash_bwd_preprocess_kernel<float><<<grid, repro::kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), d, rows,
        hd);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int bh_kv,
                                    int sq, int sk, int hd, int causal,
                                    int window, int dtype, void* stream) {
  if (dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, bh_kv,
                       sq, sk, hd, causal, window, dtype, stream);
}

extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int bh,
                                  int bh_kv, int sq, int sk, int hd,
                                  int causal, int window, int dtype,
                                  void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh,
                       bh_kv, sq, sk, hd, causal, window, dtype, stream);
}
