// flash_attention: blocked online-softmax attention for prefill.
// q (BH, Sq, hd), k/v (BH_kv, Sk, hd), out (BH, Sq, hd); bf16 or f32.
// Row bh of q attends to row bh / (BH / BH_kv) of k and v (GQA indexing;
// BH == BH_kv for multi-head attention). hd is one of 16, 32, 64, 128, 168
// (gemma3-27b) and 240 (gemma3-12b).
//
// Replaces the Pallas TPU kernel flash_attention / _flash_kernel
// (src/repro/kernels/flash_attention.py:77, body :26). Same function:
// scores scaled by 1/sqrt(hd) in f32, f32 running max m, sum l and
// accumulator, masked scores set to -1e30, l clamped at 1e-30, causal
// mask on absolute indices from 0 (k <= q, also when Sq != Sk), optional
// window (k > q - W), keys past Sk masked. On the TPU the k-block axis is
// a sequential grid axis carrying m/l/acc in VMEM scratch; here the k
// loop runs inside the block and m/l/acc live in registers.
//
// The logit softcap of the JAX model (repro/models/layers.py _softcap,
// applied in flash_attention_xla; the Pallas kernel has none): with a cap
// c > 0 a score s = q.k / sqrt(hd) becomes c * tanh(s / c) before the
// mask. It is a template flag (CAP), so a cap of 0 compiles to the
// uncapped arithmetic unchanged.
//
// Bound on an H100: bytes at the serving path's shapes. Per (bh, q, k)
// pair that survives the causal mask it does 4 * hd flops (Q K^T and P V)
// against 4 * BH * S * hd * sizeof(T) bytes for q, k, v and out: at
// S = 513, hd = 128 that is ~130 flops/byte, below the card's ~295
// flops/byte bf16 balance. Reaching it takes the tensor cores.
//
// Both kernels take an optional lse (BH, Sq) f32: where it is not null
// each row's natural log-sum-exp of its scaled (and capped) scores,
// m + log(max(l, 1e-30)), is written there for the backward
// (flash_attention_bwd.cu); a null pointer stores nothing more, the
// serving path's cost.
//
// Two kernels, chosen by dtype in repro_flash_attention (not a fallback:
// each dtype has exactly one kernel, and a call neither takes is refused):
//
// flash_tc_kernel (bf16): FA2 on the tensor cores. Grid (BH, q tiles of
//   64); blocks are dispatched x first, and y counts q tiles from the last
//   (the heaviest under the causal mask), so every head's heaviest tile
//   goes out before any lighter one and the tail of the grid is light
//   work that fills the 132 SMs; 4 warps, each owning 16 q rows. The
//   Q tile is copied once into shared memory and held as mma A-fragments
//   in registers (ldmatrix). K and V stream in tiles of 64 keys through a
//   two-stage ring in shared memory with 16-byte cp.async (zero-fill past
//   Sk), the next tile in flight while the current one is computed; they
//   stay bf16, rows padded by 16 bytes so every ldmatrix is free of bank
//   conflicts (87 KB of dynamic shared memory at hd 128). S = Q K^T and
//   O += P V are mma.sync m16n8k16 bf16 -> f32; the online softmax runs on
//   the accumulator fragments (row max and sum across the 4 threads of a
//   quad). P is rounded to bf16 for P V -- the one arithmetic difference
//   from the Pallas kernel, which keeps P in f32 (PERF.md: within the
//   kernel tolerance and the path check's noise floor). Scores are taken
//   to the exp2 domain by scale * log2(e) in f32. Tiles wholly in the
//   causal future or wholly left of the window are never loaded; only
//   tiles on the diagonal, the window edge or past Sk apply the mask.
//   With the cap, a score is capped in natural units, c * tanh(s * scale /
//   c), and only then taken to exp2 units by log2(e).
//   At hd 240 one warp's O would take 30 n-tiles (120 f32 a thread), so
//   each 16-row slice has two warps (8 a block): both compute the same S
//   and softmax (the same instructions on the same inputs, so the same
//   values), and each accumulates P V for half of O's 15 16-column
//   groups (8 and 7). Their 15 k-steps of Q fragments (60 registers) are
//   not held either: each is read again from the Q tile in shared memory
//   (ldmatrix) when it is used. The tile layout is the same (158,720
//   bytes of dynamic shared memory at hd 240, one block an SM).
//   An hd that is a multiple of 8 but not of 16 (168) is padded inside
//   the kernel to HDP = round_up(hd, 16) (176): shared-memory rows hold
//   HDP columns, of which the last HDP - hd are zero-filled by cp.async
//   (src-size 0) in Q, K and V alike, so the last k-step of Q K^T adds
//   exactly 0 and the last 16-column group of O computes zeros that are
//   never stored (the store skips n-tiles from column hd on). Global
//   addresses keep the row length hd: no tensor outside is padded. The
//   row stride is HDP + 8 (184 bf16, 23 sixteen-byte units: odd, so every
//   ldmatrix stays free of bank conflicts; 117,760 bytes at hd 168, one
//   block an SM). At hd 168 one warp keeps a 16-row slice: its O is 11
//   groups (88 f32 a thread; 242 registers, no spill), its Q fragments
//   are re-read from shared memory at each k-step, as at hd 240. With
//   the cap (whose tanhf made that instance spill 84 bytes at 255
//   registers) two warps share a slice as at hd 240, 6 and 5 groups.
//
// flash_f32_kernel (f32): the checking path (the f32 path check at 1e-3,
//   the f32 kernel tests at 2e-5), which neither bf16 nor TF32 tensor
//   cores can meet. Scalar f32 FMAs: one block per (64-row q tile, bh), 4
//   threads per q row owning float4 slices of hd (thread t the chunks t,
//   t + 4, ...: at hd 168 threads 0-1 hold 11 of the 42 chunks and 2-3
//   hold 10), K/V tiles of 32 keys in shared memory (16 above hd 128,
//   which keeps them in the 48 KB of static shared memory), q pre-scaled
//   by 1/sqrt(hd) as the Pallas kernel does; the cap acts on that
//   pre-scaled dot, c * tanh(dot / c).
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

// -- bf16 tensor-core kernel --------------------------------------------------

constexpr int kTcBQ = 64;              // q rows per block (16 per warp)
constexpr int kTcBK = 64;              // keys per shared-memory tile
constexpr int kTcThreads = 128;        // 4 warps

// warps a 16-row slice: two where one warp's O and S would spill (ptxas
// at 255 registers: hd 240, and hd 168 with the cap's tanhf)
template <int HD, bool CAP>
struct TcLayout {
  static constexpr int kPad = (HD + 15) / 16 * 16;  // columns in smem
  static constexpr int kStride = kPad + 8;          // bf16 per smem row
  static constexpr int kTile = kTcBQ * kStride;     // bf16 per 64-row tile
  static constexpr int kBytes = 5 * kTile * 2;      // Q + 2 x (K + V)
  static constexpr int kSplit = kPad > 176 || (CAP && kPad > 128) ? 2 : 1;
  static constexpr int kThreads = kTcThreads * kSplit;
  static_assert(kTcBQ == kTcBK, "Q and K/V tiles share a layout");
  static_assert(HD % 8 == 0 && (kStride / 8) % 2 == 1,
                "rows of 16-byte chunks, an odd count of them a smem row");
};

// cap: scale / c and c * log2(e) (unused without CAP)
template <int HD, bool CAP>
__global__ void __launch_bounds__(TcLayout<HD, CAP>::kThreads)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int group, int sq, int sk, int causal, int window,
                float scale_log2, float cap_in, float cap_out) {
  constexpr int kS = TcLayout<HD, CAP>::kStride;
  constexpr int kTile = TcLayout<HD, CAP>::kTile;
  constexpr int kHDP = TcLayout<HD, CAP>::kPad;  // padded columns
  constexpr int kCPR = kHDP / 8;       // 16-byte chunks per smem row
  constexpr int kCD = HD / 8;          // of them holding data
  constexpr int kKS = kHDP / 16;       // k-steps of Q K^T
  constexpr int kST = kTcBK / 8;       // n-tiles of S
  constexpr int kSplit = TcLayout<HD, CAP>::kSplit;
  constexpr int kThr = TcLayout<HD, CAP>::kThreads;
  constexpr int kNG = kHDP / 16;       // 16-column groups of O
  constexpr int kGW = (kNG + kSplit - 1) / kSplit;  // groups of this warp
  constexpr int kNT = 2 * kGW;         // n-tiles of O in this warp
  constexpr int kChunks = kTcBQ * kCPR;  // 16-byte chunks of a tile
  constexpr bool kQRegs = HD <= 128;   // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile;      // stage s at ks + s * kTile
  __nv_bfloat16* vs = ks + 2 * kTile;

  const int bh = blockIdx.x;
  const int kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first
  const int tid = threadIdx.x;
  const int warp = kSplit == 1 ? tid >> 5 : (tid >> 5) % 4;  // row slice
  const int half = kSplit == 1 ? 0 : (tid >> 5) / 4;  // O column groups
  const int lane = tid & 31;
  const int g = lane >> 2;             // row within the fragment
  const int t = lane & 3;              // thread within the quad
  const int row0 = q0 + warp * 16 + g; // this thread's rows: row0, row0 + 8

  const int q_last = min(q0 + kTcBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kTcBK * kTcBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;

  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * sk * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * sk * HD;

#pragma unroll
  for (int i = 0; i < (kChunks + kThr - 1) / kThr; ++i) {
    const int c = tid + i * kThr;
    if (kChunks % kThr != 0 && c >= kChunks) break;
    const int r = c / kCPR, cc = c % kCPR;
    const bool ok = q0 + r < sq && (kCD == kCPR || cc < kCD);
    cp_async16(smem_addr(qs + r * kS + cc * 8),
               qb + (ok ? static_cast<size_t>(q0 + r) * HD + cc * 8 : 0), ok);
  }
  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* kd = ks + stage * kTile;
    __nv_bfloat16* vd = vs + stage * kTile;
#pragma unroll
    for (int i = 0; i < (kChunks + kThr - 1) / kThr; ++i) {
      const int c = tid + i * kThr;
      if (kChunks % kThr != 0 && c >= kChunks) break;
      const int r = c / kCPR, cc = c % kCPR;
      const bool ok = kt + r < sk && (kCD == kCPR || cc < kCD);
      const size_t off = ok ? static_cast<size_t>(kt + r) * HD + cc * 8 : 0;
      cp_async16(smem_addr(kd + r * kS + cc * 8), kb + off, ok);
      cp_async16(smem_addr(vd + r * kS + cc * 8), vb + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(k_begin, 0);
  cp_async_commit();                   // group 0: Q and the first K/V tile

  uint32_t qf[kQRegs ? kKS : 1][4];
  float oacc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * kTcBK;
    if (it + 1 < n_tiles) load_kv(kt + kTcBK, (it + 1) & 1);
    cp_async_commit();                 // (empty on the last tile)
    cp_async_wait<1>();                // this tile (and Q) has landed
    __syncthreads();
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(qs + r * kS + kk * 16 + (lane >> 4) * 8), qf[kk]);
      }
    }
    const __nv_bfloat16* kt_s = ks + (it & 1) * kTile;
    const __nv_bfloat16* vt_s = vs + (it & 1) * kTile;

    // S = Q K^T (16 rows x 64 keys per warp)
    float s[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      if (!kQRegs) {                   // this k-step's Q fragment from smem
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(qs + r * kS + kk * 16 + (lane >> 4) * 8), qf[0]);
      }
      const uint32_t (&a)[4] = qf[kQRegs ? kk : 0];
#pragma unroll
      for (int nj = 0; nj < kST / 2; ++nj) {
        uint32_t b[4];
        const int r = nj * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(smem_addr(kt_s + r * kS + kk * 16 + ((lane >> 3) & 1) * 8), b);
        mma_bf16(s[2 * nj], a, b[0], b[1]);
        mma_bf16(s[2 * nj + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, online softmax on the fragments
    const bool need_mask = kt + kTcBK > sk ||
                           (causal && kt + kTcBK - 1 > q0) ||
                           (window > 0 && kt <= q0 + kTcBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = CAP ? cap_out * tanhf(s[j][e] * cap_in)
                      : s[j][e] * scale_log2;
        if (need_mask) {
          const int key = kt + 8 * j + 2 * t + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          bool ok = key < sk;
          if (causal) ok = ok && key <= qi;
          if (window > 0) ok = ok && key > qi - window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < kST; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[h] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kST; ++j) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(s[j][e] - mx);
          s[j][e] = p;
          rs += p;
        }
      }
      l[h] = l[h] * alpha + rs;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        oacc[j][2 * h] *= alpha;
        oacc[j][2 * h + 1] *= alpha;
      }
      m[h] = mx;
    }

    // O += P V, P as bf16 A-fragments (the C layout of S is the A layout)
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int gi = 0; gi < kGW; ++gi) {
        const int nd = half * kGW + gi;  // this warp's column group
        if (kSplit != 1 && nd >= kNG) break;
        uint32_t b[4];
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_addr(vt_s + r * kS + nd * 16 + (lane >> 4) * 8), b);
        mma_bf16(oacc[2 * gi], a, b[0], b[1]);
        mma_bf16(oacc[2 * gi + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                   // this stage is free for tile it + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int qi = row0 + 8 * h;
    // m is in exp2 units: the natural log-sum-exp is m ln 2 + ln(l)
    if (lse != nullptr && qi < sq && half == 0 && t == 0)
      lse[static_cast<size_t>(bh) * sq + qi] = m[h] * kLn2 + logf(denom);
    if (qi < sq) {
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * sq + qi) * HD +
                            half * kGW * 16;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (kSplit != 1 && half * kGW + j / 2 >= kNG) break;
        if (HD != kHDP && half * kGW * 16 + 8 * j >= HD) break;  // padding
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(oacc[j][2 * h] / denom,
                                  oacc[j][2 * h + 1] / denom);
      }
    }
  }
}

template <int HD, bool CAP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int bh, int group, int sq, int sk, int causal,
              int window, float cap, cudaStream_t stream) {
  constexpr int kBytes = TcLayout<HD, CAP>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + kTcBQ - 1) / kTcBQ);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  flash_tc_kernel<HD, CAP><<<grid, TcLayout<HD, CAP>::kThreads, kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, group, sq, sk, causal, window, scale_log2, CAP ? scale / cap : 0.f,
      CAP ? cap * kLog2e : 0.f);
  return 0;
}

// -- f32 CUDA-core kernel ------------------------------------------------------

constexpr int kBQ = 64;                 // q rows per block
constexpr int kTPR = 4;                 // threads per q row
constexpr int kThreads = kBQ * kTPR;    // 256

template <int HD, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int group, int sq, int sk,
                 int causal, int window, float scale, float cap,
                 float inv_cap) {
  // keys per shared-memory tile: K and V tiles stay within the 48 KB of
  // static shared memory
  constexpr int kBK = HD > 128 ? 16 : 32;
  constexpr int kC4 = HD / 4;           // float4 chunks a row
  constexpr int kNV4 = (kC4 + kTPR - 1) / kTPR;  // float4 chunks per thread
  constexpr int kDPT = 4 * kNV4;        // head dims per thread
  static_assert(HD % 4 == 0, "hd must be a multiple of 4");
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

  // chunk c of this thread covers dims 4 * (sub + kTPR * c) .. + 3; where
  // kC4 is not a multiple of kTPR the last one lies past the row for some
  // threads (own[c] false): its q and acc are 0 and it is never read or
  // written
  bool own[kNV4];
#pragma unroll
  for (int c = 0; c < kNV4; ++c) own[c] = kC4 % kTPR == 0 || sub + kTPR * c < kC4;
  float qf[kDPT];
  float acc[kDPT];
  const float* qrow = q + (static_cast<size_t>(bh) * sq + (q_valid ? qi : 0)) * HD;
#pragma unroll
  for (int c = 0; c < kNV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (sub + kTPR * c) + e;
      qf[4 * c + e] = q_valid && own[c] ? qrow[dim] * scale : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  const float* kbase = k + static_cast<size_t>(kvh) * sk * HD;
  const float* vbase = v + static_cast<size_t>(kvh) * sk * HD;
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
        kv = kbase[off];
        vv = vbase[off];
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
        if (!own[c]) continue;
        const float4 kv4 = ks[j][sub + kTPR * c];
        part += qf[4 * c] * kv4.x + qf[4 * c + 1] * kv4.y +
                qf[4 * c + 2] * kv4.z + qf[4 * c + 3] * kv4.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (CAP) part = cap * tanhf(part * inv_cap);
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
        if (!own[c]) continue;
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
    if (lse != nullptr && sub == 0)
      lse[static_cast<size_t>(bh) * sq + qi] = m + logf(denom);
    float* orow = o + (static_cast<size_t>(bh) * sq + qi) * HD;
#pragma unroll
    for (int c = 0; c < kNV4; ++c) {
      if (!own[c]) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[4 * (sub + kTPR * c) + e] = acc[4 * c + e] / denom;
      }
    }
  }
}

template <int HD, bool CAP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int group, int sq, int sk, int causal,
               int window, float cap, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  flash_f32_kernel<HD, CAP><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, group, sq,
      sk, causal, window, scale, cap, CAP ? 1.f / cap : 0.f);
  return 0;
}

// dtype picks the kernel: bf16 -> tensor cores, f32 -> CUDA cores; a cap
// > 0 the capped instance
template <int HD, bool CAP>
int launch_dt(int dtype, const void* q, const void* k, const void* v,
              void* o, float* lse, int bh, int group, int sq, int sk,
              int causal, int window, float cap, cudaStream_t stream) {
  if (dtype == kBF16) return launch_tc<HD, CAP>(q, k, v, o, lse, bh, group, sq, sk, causal, window, cap, stream);
  if (dtype == kF32) return launch_f32<HD, CAP>(q, k, v, o, lse, bh, group, sq, sk, causal, window, cap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              void* o, float* lse, int bh, int group, int sq, int sk,
              int causal, int window, float cap, cudaStream_t stream) {
  if (cap > 0.f) return launch_dt<HD, true>(dtype, q, k, v, o, lse, bh, group, sq, sk, causal, window, cap, stream);
  return launch_dt<HD, false>(dtype, q, k, v, o, lse, bh, group, sq, sk, causal, window, cap, stream);
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int bh,
                                     int bh_kv, int sq, int sk, int hd,
                                     int causal, int window, float softcap,
                                     int dtype, void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0 || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bh_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (hd) {
    case 16: rc = repro::launch_hd<16>(dtype, q, k, v, o, static_cast<float*>(lse), bh, group, sq, sk, causal, window, softcap, s); break;
    case 32: rc = repro::launch_hd<32>(dtype, q, k, v, o, static_cast<float*>(lse), bh, group, sq, sk, causal, window, softcap, s); break;
    case 64: rc = repro::launch_hd<64>(dtype, q, k, v, o, static_cast<float*>(lse), bh, group, sq, sk, causal, window, softcap, s); break;
    case 128: rc = repro::launch_hd<128>(dtype, q, k, v, o, static_cast<float*>(lse), bh, group, sq, sk, causal, window, softcap, s); break;
    case 168: rc = repro::launch_hd<168>(dtype, q, k, v, o, static_cast<float*>(lse), bh, group, sq, sk, causal, window, softcap, s); break;
    case 240: rc = repro::launch_hd<240>(dtype, q, k, v, o, static_cast<float*>(lse), bh, group, sq, sk, causal, window, softcap, s); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
