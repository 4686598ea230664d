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
// and outputs. dQ has a kernel of its own that computes S and dP again
// (14 hd flops a pair, not FA2's 10 with a dQ summed by float atomics):
// the price of sums in a fixed order.
//
// No float atomics: dK and dV of a key tile are summed by the one block
// that owns it, over the G query heads of its KV head (GQA, in head
// order) and the query tiles in order; dQ of a query tile by the one
// block that owns it, over the key tiles in order. Every sum has a fixed
// order, so two runs give the same bits. Tiles wholly outside the causal
// or window band are never loaded; only a tile on the causal diagonal,
// on the window edge or past S masks per element.
//
// Two designs, picked by launch_hd from (dtype, hd) before any launch,
// as the forward picks by dtype. This is a dispatch, not a fallback:
// each (dtype, hd) has exactly one kernel, and nothing catches a failed
// build or launch to retry another.
//
//   bf16, every hd (16 / 32 / 64 / 128 / 168 / 240): flash_bwd_dkdv_tc_kernel
//     and flash_bwd_dq_tc_kernel, FA2's backward on the tensor cores
//     (mma.sync m16n8k16, bf16 in, f32 accumulators), below.
//   f32, every hd: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, the
//     SIMT form, every product an f32 FMA. They are the checking path
//     (the kernel tests at 2e-5, the train path check at 1e-3), which
//     neither bf16 nor TF32 tensor cores can meet, as flash_f32_kernel
//     is for the forward. They are not redesigned: no model trains in
//     f32 on the card.
//
// The tensor-core design. Tiles of 64 rows in shared memory as bf16,
// each row kPad + 8 bf16 (kPad = hd rounded up to 16; an odd count of
// 16-byte units, so every ldmatrix is free of bank conflicts), filled by
// 16-byte cp.async with zero-fill past S. A warp owns 16 rows (keys in
// dkdv, query rows in dq).
//   dkdv: grid (BH_kv, key tiles of 64), the key tile counted from 0 on
//     y, so every KV head's heaviest tile under the causal mask (the
//     lowest keys see the most query rows) goes out before any lighter
//     one. The block's K and V tiles stay in shared memory; the (query
//     head, query tile) pairs it needs stream their Q and dO tiles, lse
//     and D through a two-stage cp.async ring, the next pair in flight
//     while this one is computed. Keys are the M dimension: a warp owns
//     16 keys and computes S^T = K Q^T and dP^T = V dO^T over sub-steps
//     of kNQ query columns (32 above hd 64, where dK and dV hold 128 f32
//     a thread at hd 128; 64 below). P^T and dS^T are formed on the
//     accumulator fragments, and the C layout of an m16n8 accumulator is
//     the A layout of m16n8k16: packed to bf16 they go straight from
//     registers into dV += P^T dO and dK += dS^T Q, the B operand read
//     from the dO or Q tile by ldmatrix.trans. Nothing of P or dS touches
//     shared memory. K and V fragments are read again from shared memory
//     at each k-step, not held. dK is scaled once, at the store.
//   dq: grid (BH, query tiles of 64), y counted from the last tile (the
//     heaviest under the causal mask), the forward's shape: the Q and
//     dO tiles are held (as A fragments in registers at hd <= 64, read
//     again at each k-step above), K and V tiles stream through the
//     two-stage ring. S = Q K^T, dP = dO V^T and dS = P (dP - D) on the
//     fragments, then dQ += dS K with dS packed to bf16 A fragments and
//     K read by ldmatrix.trans.
//   P is taken in the exp2 domain, as the forward does: exp2(s scale
//   log2(e) - lse log2(e)), lse being the forward's natural log-sum-exp.
//   P and dS are rounded to bf16 before their products (the forward
//   rounds P for P V the same way); every sum is f32.
//
// The wide heads, hd 168 (gemma3-27b) and 240 (gemma3-12b), in the same
// two kernels:
//   - hd 168 is padded to kPad = 176 in shared memory only, as the
//     forward pads it: columns 168-175 of every Q, K, V and dO tile are
//     zero-filled by cp.async (src-size 0), so the last k-step of S^T,
//     dP^T, S and dP adds exactly 0; the global rows keep 168 columns
//     (336 bytes, 21 sixteen-byte chunks) and no column from 168 on of
//     dQ, dK or dV is stored. Rows of 184 bf16 (23 units) at hd 168 and
//     248 (31 units) at hd 240. One block an SM: dkdv 142,336 / 191,488
//     bytes, dq 141,312 / 190,464 at hd 168 / 240.
//   - dkdv: one warp's dK and dV would take kPad f32 a thread (176, 240)
//     beside S^T and dP^T, past the 255-register ceiling. So each 16-key
//     slice has two warps (8 a block, 256 threads), each owning half of
//     dK's and dV's 16-column groups (6 and 5 at hd 168, 8 and 7 at hd
//     240: 96 or 128 f32 a thread). Both warps of a pair form the slice's
//     S^T and dP^T over the whole head, as the forward's two warps of a
//     slice both form S at hd 240: the same instructions on the same
//     inputs, so the same values. Chosen over each warp taking half of
//     the contraction and the halves summed in shared memory: that would
//     save a third of the tensor-core work (12 hd flops a pair here
//     against 8) but add an exchange of 32 f32 a thread and two pair
//     barriers at each sub-step, and make dS a sum of two halves; the
//     duplicate keeps every sum in the one-warp order.
//   - dq: 16 rows of dQ take kPad / 2 f32 a thread (88, 120) beside S and
//     dP, so S and dP go in sub-steps of kNK keys through the 64-key tile
//     (32 at hd 168, 16 at hd 240: 16 or 8 f32 each), one warp a 16-row
//     slice as at hd <= 128. dQ's sum order is that of the whole tile:
//     its 16-key k-steps in order.
//   - ptxas (sm_90a): dkdv 222 registers at hd 168, no spill; 255 at hd
//     240 with 32 bytes spilled (sub-steps of 16 query columns spill
//     nothing but took 3.60 ms against 3.14-3.22 at gemma3-12b's global
//     layer on an H100, so the 32 stay); dq 255 at both, 4 bytes spilled
//     at hd 168.
//
// The SIMT design. Tiles of 32 query rows and 32 keys are held in shared
// memory as f32 rows of hd + 1 floats (an odd stride: the column loads
// of a warp fall in distinct banks), with the 32 x 32 tiles of P and dS
// beside them. 256 threads: in the score phase thread (ty, tx) computes
// the four entries (ty + 16a, tx + 16b) of S and dP; in the product
// phase a row of the output tile belongs to 8 threads, thread c of them
// owning columns c, c + 8, ... (hd / 8 f32 accumulators each for dK and
// dV, or for dQ).
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

// -- f32 SIMT kernels ------------------------------------------------------------

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
// tile; rows past nrows are zero
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int nrows) {
  for (int e = threadIdx.x; e < kB * HD; e += kThreads) {
    const int r = e / HD, c = e - r * HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + c] =
        row < nrows ? src[static_cast<size_t>(row) * HD + c] : 0.f;
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
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int group, int sq, int sk,
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
  load_tile<HD>(ks, k + static_cast<size_t>(kvh) * sk * HD, k0, sk);
  load_tile<HD>(vs, v + static_cast<size_t>(kvh) * sk * HD, k0, sk);
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
      load_tile<HD>(qs, q + bh * sq * HD, q0, sq);
      load_tile<HD>(dos, dout + bh * sq * HD, q0, sq);
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
      dk[off + d] = dk_acc[c] * scale;
      dv[off + d] = dv_acc[c];
    }
  }
}

// grid (query tiles, BH)
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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
  load_tile<HD>(qs, q + bh * sq * HD, q0, sq);
  load_tile<HD>(dos, dout + bh * sq * HD, q0, sq);
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
    load_tile<HD>(ks, k + kvh * sk * HD, k0, sk);
    load_tile<HD>(vs, v + kvh * sk * HD, k0, sk);
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
    float* row = dq + (bh * sq + q0 + i) * HD;
#pragma unroll
    for (int c = 0; c < kDPT; ++c)
      row[c0 + kCols * c] = acc[c] * scale;
  }
}

// -- bf16 tensor-core kernels --------------------------------------------------

constexpr int kTcB = 64;              // rows of a tile: keys or query rows
constexpr int kTcThreads = 128;       // 4 warps, 16 rows each

template <int HD>
struct BwdTcLayout {
  static constexpr int kPad = (HD + 15) / 16 * 16;  // columns in smem
  static constexpr int kStride = kPad + 8;      // bf16 a smem row
  static constexpr int kTile = kTcB * kStride;  // bf16 a 64-row tile
  // dkdv: K, V and two stages of (Q, dO), then two stages of (lse, D)
  static constexpr int kDkdvBytes = 6 * kTile * 2 + 2 * 2 * kTcB * 4;
  // dq: Q, dO and two stages of (K, V)
  static constexpr int kDqBytes = 6 * kTile * 2;
  // dkdv: warps a 16-key slice, two above hd 128 (each half of dK and
  // dV's column groups); query columns of a sub-step: S^T and dP^T take
  // kNQ / 2 f32 a thread each beside dK and dV
  static constexpr int kSplit = kPad > 128 ? 2 : 1;
  static constexpr int kDkdvThreads = kTcThreads * kSplit;
  static constexpr int kNQ = HD > 64 ? 32 : 64;
  // dq: keys of a sub-step (S and dP take kNK / 2 f32 a thread each
  // beside dQ's kPad / 2); per wide instance the faster of 16 and 32 on
  // an H100 (hd 240: 16, no spill; hd 168: 32, 4 bytes spilled, where
  // 16 spills 16 and is slower)
  static constexpr int kNK = kPad > 176 ? 16 : kPad > 128 ? 32 : 64;
  static constexpr bool kHold = HD <= 64;       // dq: Q, dO fragments held
  static_assert(HD % 8 == 0 && kPad <= 240, "tensor-core head dims");
  static_assert((kStride / 8) % 2 == 1,
                "an odd count of 16-byte units a smem row");
  static_assert(kTcThreads == 2 * kTcB, "a thread an lse or D row");
};

// rows row0 .. row0 + 63 of a (nrows, HD) bf16 matrix into a smem tile
// of BwdTcLayout<HD>::kStride a row by THREADS threads, 16-byte
// cp.async; rows past nrows, and the pad columns HD .. kPad - 1, are
// zero-filled (their source is not read)
template <int HD, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int nrows) {
  constexpr int kS = BwdTcLayout<HD>::kStride;
  constexpr int kCPR = BwdTcLayout<HD>::kPad / 8;  // 16-byte chunks a row
  constexpr int kCD = HD / 8;           // of them holding data
  constexpr int kChunks = kTcB * kCPR;
#pragma unroll
  for (int i = 0; i < (kChunks + THREADS - 1) / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (kChunks % THREADS != 0 && c >= kChunks) break;
    const int r = c / kCPR, cc = c % kCPR;
    const bool ok = row0 + r < nrows && (kCD == kCPR || cc < kCD);
    cp_async16(smem_addr(dst + r * kS + cc * 8),
               src + (ok ? static_cast<size_t>(row0 + r) * HD + cc * 8 : 0),
               ok);
  }
}

// The m16n8k16 operands from a row-major smem tile of stride kS (the
// forward's loads). ldsm_a: the A fragment of rows rb .. rb + 15 and
// columns c0 .. c0 + 15. ldsm_b: the B fragments of two n-tiles, the
// tile's rows nb .. nb + 15 as n and columns c0 .. c0 + 15 as k (b[0],
// b[1] rows nb..; b[2], b[3] rows nb + 8..). ldsm_bt: the same read
// transposed, rows kb .. kb + 15 as k and columns nb .. nb + 15 as n.
template <int kS>
__device__ __forceinline__ void ldsm_a(const __nv_bfloat16* t, int rb,
                                       int c0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = rb + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(smem_addr(t + r * kS + c0 + (lane >> 4) * 8), a);
}

template <int kS>
__device__ __forceinline__ void ldsm_b(const __nv_bfloat16* t, int nb,
                                       int c0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = nb + (lane & 7) + (lane >> 4) * 8;
  ldsm_x4(smem_addr(t + r * kS + c0 + ((lane >> 3) & 1) * 8), b);
}

template <int kS>
__device__ __forceinline__ void ldsm_bt(const __nv_bfloat16* t, int kb,
                                        int nb, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = kb + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4_trans(smem_addr(t + r * kS + nb + (lane >> 4) * 8), b);
}

// the A fragment of k-step kk from the accumulators of n-tiles 2 kk and
// 2 kk + 1 (the C layout of m16n8 is the A layout of m16n8k16), as bf16
template <int N>
__device__ __forceinline__ void pack_a(const float (&c)[N][4], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// grid (BH_kv, key tiles): a block owns keys k0 .. k0 + 63 of KV head
// blockIdx.x, a warp (above hd 128 a pair of warps) 16 of them
template <int HD>
__global__ void __launch_bounds__(BwdTcLayout<HD>::kDkdvThreads)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int group, int sq,
                         int sk, int causal, int window, float scale,
                         float scale_log2) {
  using L = BwdTcLayout<HD>;
  constexpr int kS = L::kStride, kTile = L::kTile, kNQ = L::kNQ;
  constexpr int kThr = L::kDkdvThreads, kSplit = L::kSplit;
  constexpr int kKS = L::kPad / 16;    // k-steps of S^T over the padded hd
  constexpr int kNT = kNQ / 8;         // n-tiles of S^T in a sub-step
  constexpr int kNG = L::kPad / 16;    // 16-column groups of dK and dV
  constexpr int kGW = (kNG + kSplit - 1) / kSplit;  // groups of this warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* qs = vs + kTile;      // stage s: Q at qs + 2 s kTile, dO after
  float* rows_s = reinterpret_cast<float*>(qs + 4 * kTile);  // lse, D a stage

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * kTcB;
  const int tid = threadIdx.x;
  const int warp = kSplit == 1 ? tid >> 5 : (tid >> 5) % 4;  // key slice
  const int half = kSplit == 1 ? 0 : (tid >> 5) / 4;  // dK/dV column groups
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  // query rows that see a key of this tile: q >= k0 (causal) and
  // q < k_max + W (window), in tiles of 64 from q_lo; the G query heads
  // of the KV head in order, each over its query tiles in order
  const int k_max = min(k0 + kTcB, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_max + window) : sq;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + kTcB - 1) / kTcB : 0;
  const int n_it = group * n_qt;

  load_tile_async<HD, kThr>(ks, k + static_cast<size_t>(kvh) * sk * HD, k0,
                            sk);
  load_tile_async<HD, kThr>(vs, v + static_cast<size_t>(kvh) * sk * HD, k0,
                            sk);
  auto load_q = [&](int it, int stage) {
    const int gi = it / n_qt;
    const int q0 = q_lo + (it - gi * n_qt) * kTcB;
    const size_t bh = static_cast<size_t>(kvh) * group + gi;
    __nv_bfloat16* qd = qs + stage * 2 * kTile;
    load_tile_async<HD, kThr>(qd, q + bh * sq * HD, q0, sq);
    load_tile_async<HD, kThr>(qd + kTile, dout + bh * sq * HD, q0, sq);
    // threads 0-63 copy lse of the 64 rows, 64-127 their D (0 past sq)
    if (tid < 2 * kTcB) {
      const int r = tid & (kTcB - 1);
      const bool ok = q0 + r < sq;
      cp_async4(smem_addr(rows_s + stage * 2 * kTcB + tid),
                (tid < kTcB ? lse : delta) + (ok ? bh * sq + q0 + r : 0), ok);
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();                   // group 0: K, V and the first pair

  float dka[2 * kGW][4], dva[2 * kGW][4];
#pragma unroll
  for (int j = 0; j < 2 * kGW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();                 // (empty on the last pair)
    cp_async_wait<1>();                // this pair (and K, V) has landed
    __syncthreads();
    const int q0 = q_lo + (it % n_qt) * kTcB;
    const __nv_bfloat16* qt = qs + (it & 1) * 2 * kTile;
    const __nv_bfloat16* dot = qt + kTile;
    const float* lse_t = rows_s + (it & 1) * 2 * kTcB;
    const float* d_t = lse_t + kTcB;
    const bool need_mask = q0 + kTcB > sq || k0 + kTcB > sk ||
                           (causal && k0 + kTcB - 1 > q0) ||
                           (window > 0 && k0 <= q0 + kTcB - 1 - window);
#pragma unroll
    for (int h = 0; h < kTcB / kNQ; ++h) {
      const int c0 = h * kNQ;          // the sub-step's first query column
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kNQ queries a warp (both
      // warps of a pair alike)
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t a[4];
        ldsm_a<kS>(ks, warp * 16, kk * 16, a);
#pragma unroll
        for (int nj = 0; nj < kNT / 2; ++nj) {
          uint32_t b[4];
          ldsm_b<kS>(qt, c0 + nj * 16, kk * 16, b);
          mma_bf16(s[2 * nj], a, b[0], b[1]);
          mma_bf16(s[2 * nj + 1], a, b[2], b[3]);
        }
        ldsm_a<kS>(vs, warp * 16, kk * 16, a);
#pragma unroll
        for (int nj = 0; nj < kNT / 2; ++nj) {
          uint32_t b[4];
          ldsm_b<kS>(dot, c0 + nj * 16, kk * 16, b);
          mma_bf16(dp[2 * nj], a, b[0], b[1]);
          mma_bf16(dp[2 * nj + 1], a, b[2], b[3]);
        }
      }
      // P^T = exp2(s scale log2e - lse log2e) and dS^T = P^T (dP^T - D)
      // on the fragments: element e of n-tile j is key key0 + 8 (e >> 1),
      // query column c0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(d_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dd = (e & 1) ? d2.y : d2.x;
          float p = exp2f(s[j][e] * scale_log2 - lq * kLog2e);
          if (need_mask) {
            const int qi = q0 + col + (e & 1);
            const int key = key0 + 8 * (e >> 1);
            bool ok = qi < sq && key < sk;
            if (causal) ok = ok && key <= qi;
            if (window > 0) ok = ok && key > qi - window;
            p = ok ? p : 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dd);
        }
      }
      // dV += P^T dO and dK += dS^T Q over this warp's column groups, A
      // from the fragments as bf16
#pragma unroll
      for (int kk = 0; kk < kNQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pack_a(s, kk, pa);
        pack_a(dp, kk, da);
#pragma unroll
        for (int gi = 0; gi < kGW; ++gi) {
          const int nd = half * kGW + gi;
          if (kSplit != 1 && nd >= kNG) break;
          uint32_t b[4];
          ldsm_bt<kS>(dot, c0 + kk * 16, nd * 16, b);
          mma_bf16(dva[2 * gi], pa, b[0], b[1]);
          mma_bf16(dva[2 * gi + 1], pa, b[2], b[3]);
          ldsm_bt<kS>(qt, c0 + kk * 16, nd * 16, b);
          mma_bf16(dka[2 * gi], da, b[0], b[1]);
          mma_bf16(dka[2 * gi + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // this stage is free for pair it + 2
  }
  cp_async_wait<0>();

  // n-tile j of this warp holds columns half kGW 16 + 8 j ..; none from
  // HD on (the padding) is stored
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key < sk) {
      const size_t off = (static_cast<size_t>(kvh) * sk + key) * HD +
                         half * kGW * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2 * kGW; ++j) {
        if (kSplit != 1 && half * kGW + j / 2 >= kNG) break;
        if (HD != L::kPad && half * kGW * 16 + 8 * j >= HD) break;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(dka[j][2 * hh] * scale,
                                  dka[j][2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dva[j][2 * hh], dva[j][2 * hh + 1]);
      }
    }
  }
}

// grid (BH, query tiles): y counts query tiles from the last (the
// heaviest under the causal mask); a warp owns 16 query rows
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int group, int sq,
                       int sk, int causal, int window, float scale,
                       float scale_log2) {
  using L = BwdTcLayout<HD>;
  constexpr int kS = L::kStride, kTile = L::kTile, kNK = L::kNK;
  constexpr bool kHold = L::kHold;
  constexpr int kKS = L::kPad / 16;    // k-steps of S over the padded hd
  constexpr int kST = kNK / 8;         // n-tiles of S in a sub-step
  constexpr int kDT = L::kPad / 8;     // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ks = dos + kTile;     // stage s: K at ks + 2 s kTile, V after

  const int bh = blockIdx.x;
  const int kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcB;  // heaviest first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  // keys this tile's rows see: k <= q_last (causal), k > q0 - W (window,
  // from the 64-key tile holding it), in order
  const int q_last = min(q0 + kTcB, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kTcB * kTcB;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcB - 1) / kTcB : 0;

  const size_t qoff = static_cast<size_t>(bh) * sq;
  const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * sk * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * sk * HD;
  load_tile_async<HD, kTcThreads>(qs, q + qoff * HD, q0, sq);
  load_tile_async<HD, kTcThreads>(dos, dout + qoff * HD, q0, sq);
  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* kd = ks + stage * 2 * kTile;
    load_tile_async<HD, kTcThreads>(kd, kb, kt, sk);
    load_tile_async<HD, kTcThreads>(kd + kTile, vb, kt, sk);
  };
  if (n_tiles > 0) load_kv(k_begin, 0);
  cp_async_commit();                   // group 0: Q, dO and the first K/V

  // this thread's rows: lse in exp2 units, and D (0 past sq)
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + 8 * h;
    lse2[h] = qi < sq ? lse[qoff + qi] * kLog2e : 0.f;
    dd[h] = qi < sq ? delta[qoff + qi] : 0.f;
  }

  uint32_t qf[kHold ? kKS : 1][4], of[kHold ? kKS : 1][4];
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * kTcB;
    if (it + 1 < n_tiles) load_kv(kt + kTcB, (it + 1) & 1);
    cp_async_commit();                 // (empty on the last tile)
    cp_async_wait<1>();                // this tile (and Q, dO) has landed
    __syncthreads();
    if (kHold && it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        ldsm_a<kS>(qs, warp * 16, kk * 16, qf[kk]);
        ldsm_a<kS>(dos, warp * 16, kk * 16, of[kk]);
      }
    }
    const __nv_bfloat16* kt_s = ks + (it & 1) * 2 * kTile;
    const __nv_bfloat16* vt_s = kt_s + kTile;
    const bool need_mask = kt + kTcB > sk ||
                           (causal && kt + kTcB - 1 > q0) ||
                           (window > 0 && kt <= q0 + kTcB - 1 - window);

#pragma unroll
    for (int h = 0; h < kTcB / kNK; ++h) {
      const int c0 = h * kNK;          // the sub-step's first key in the tile
      // S = Q K^T and dP = dO V^T: 16 rows x kNK keys a warp
      float s[kST][4], dp[kST][4];
#pragma unroll
      for (int j = 0; j < kST; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        if (!kHold) ldsm_a<kS>(qs, warp * 16, kk * 16, qf[0]);
#pragma unroll
        for (int nj = 0; nj < kST / 2; ++nj) {
          uint32_t b[4];
          ldsm_b<kS>(kt_s, c0 + nj * 16, kk * 16, b);
          mma_bf16(s[2 * nj], qf[kHold ? kk : 0], b[0], b[1]);
          mma_bf16(s[2 * nj + 1], qf[kHold ? kk : 0], b[2], b[3]);
        }
        if (!kHold) ldsm_a<kS>(dos, warp * 16, kk * 16, of[0]);
#pragma unroll
        for (int nj = 0; nj < kST / 2; ++nj) {
          uint32_t b[4];
          ldsm_b<kS>(vt_s, c0 + nj * 16, kk * 16, b);
          mma_bf16(dp[2 * nj], of[kHold ? kk : 0], b[0], b[1]);
          mma_bf16(dp[2 * nj + 1], of[kHold ? kk : 0], b[2], b[3]);
        }
      }

      // dS = P (dP - D), P = exp2(s scale log2e - lse log2e), 0 where masked
#pragma unroll
      for (int j = 0; j < kST; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float p = exp2f(s[j][e] * scale_log2 - lse2[hr]);
          if (need_mask) {
            const int key = kt + c0 + 8 * j + 2 * t + (e & 1);
            const int qi = row0 + 8 * hr;
            bool ok = key < sk;
            if (causal) ok = ok && key <= qi;
            if (window > 0) ok = ok && key > qi - window;
            p = ok ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dd[hr]);
        }
      }

      // dQ += dS K, dS as bf16 A fragments, K read transposed
#pragma unroll
      for (int kk = 0; kk < kNK / 16; ++kk) {
        uint32_t da[4];
        pack_a(dp, kk, da);
#pragma unroll
        for (int nd = 0; nd < kDT / 2; ++nd) {
          uint32_t b[4];
          ldsm_bt<kS>(kt_s, c0 + kk * 16, nd * 16, b);
          mma_bf16(acc[2 * nd], da, b[0], b[1]);
          mma_bf16(acc[2 * nd + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // this stage is free for tile it + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + 8 * h;
    if (qi < sq) {
      __nv_bfloat16* row = dq + (qoff + qi) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        if (HD != L::kPad && 8 * j >= HD) break;  // the padding
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                  acc[j][2 * h + 1] * scale);
      }
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int bh, int group, int sq, int sk, int causal,
              int window, cudaStream_t stream) {
  using L = BwdTcLayout<HD>;
  using bf16 = __nv_bfloat16;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  if (dk != nullptr) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkdv_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkdvBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(bh / group, (sk + kTcB - 1) / kTcB);
    flash_bwd_dkdv_tc_kernel<HD>
        <<<grid, L::kDkdvThreads, L::kDkdvBytes, stream>>>(
            qp, kp, vp, dp, lse, delta, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), group, sq, sk, causal, window, scale,
            scale_log2);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(bh, (sq + kTcB - 1) / kTcB);
    flash_bwd_dq_tc_kernel<HD><<<grid, kTcThreads, L::kDqBytes, stream>>>(
        qp, kp, vp, dp, lse, delta, static_cast<bf16*>(dq), group, sq, sk,
        causal, window, scale, scale_log2);
  }
  return 0;
}

// -- dispatch ------------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int bh, int group, int sq, int sk, int causal,
               int window, cudaStream_t stream) {
  constexpr int kBytes = BwdLayout<HD>::kBytes;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dp = static_cast<const float*>(dout);
  if (dk != nullptr) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((sk + kB - 1) / kB, bh / group);
    flash_bwd_dkdv_kernel<HD><<<grid, kThreads, kBytes, stream>>>(
        qp, kp, vp, dp, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), group, sq, sk, causal, window, scale);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((sq + kB - 1) / kB, bh);
    flash_bwd_dq_kernel<HD><<<grid, kThreads, kBytes, stream>>>(
        qp, kp, vp, dp, lse, delta, static_cast<float*>(dq), group, sq, sk,
        causal, window, scale);
  }
  return 0;
}

// (dtype, hd) picks the kernel: bf16 the tensor cores, f32 the SIMT
// kernels. Not a fallback: one kernel for each pair, and an error from it
// is returned, never retried.
template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, void* dk, void* dv, int bh, int group, int sq,
              int sk, int causal, int window, cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_tc<HD>(q, k, v, dout, lse, delta, dq, dk, dv, bh, group,
                         sq, sk, causal, window, stream);
  if (dtype == kF32)
    return launch_f32<HD>(q, k, v, dout, lse, delta, dq, dk, dv, bh, group,
                          sq, sk, causal, window, stream);
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
