// ssm_scan: the Mamba2 (SSD) selective scan of one sequence per head.
// xbar (BH, S, hd) f32 dt-weighted inputs, B/C (BH_bc, S, ds) bf16 or f32
// (row bh reads B/C row bh / (BH / BH_bc): the heads of a sequence share
// one B/C group), cumlog (BH, S) f32, the cumulative log-decay reset at
// every `chunk` steps. Writes y (BH, S, hd) f32 and the final state
// h (BH, hd, ds) f32, from a zero initial state. S need not be a chunk
// multiple: a short last chunk is the same function as one padded with
// zero inputs and zero log-decay.
//
// Replaces the Pallas TPU kernel ssm_scan / _ssm_kernel
// (src/repro/kernels/ssm_scan.py:49, body :18), which computes each chunk
// in the quadratic SSD form on the MXU and drops the final state:
//   Y = (C B^T o L) X + diag(exp(cum)) C H^T,  L[i, j] = exp(cum_i - cum_j)
//   for j <= i, and H <- H exp(cum_last) + (X o exp(cum_last - cum))^T B.
//
// Two kernels, chosen by the dtype of B/C in repro_ssm_scan (not a
// fallback: each dtype has exactly one kernel, and any other is refused):
//
// ssm_tc_kernel (bf16 B/C, what the bf16 serving path passes): the chunked
//   form on the tensor cores. Bound on an H100: bytes. At zamba2-1.2b's
//   shape (BH 64, S 600, hd = ds = 64) it moves ~21.0 MB (xbar and y
//   19.7 MB, h 1.05 MB, B/C and cumlog 0.3 MB): 0.0063 ms, against ~1.7
//   GFLOP of TF32 products in 64-step tiles as run (3xTF32, below),
//   0.0035 ms at the 495 TFLOP/s TF32 peak.
//   - Grid (BH, hd / 32): a block owns 32 rows of the state, the rows of h
//     being independent (128 blocks at zamba2's shape, one wave on 132
//     SMs), with 12 warps: 8 for Y, 4 for the state. The state H (32 x
//     ds) f32 lives in the 4 state warps' mma accumulator fragments for
//     the whole sequence; a copy in shared memory, split into two TF32
//     terms, feeds the next tile's C H^T. The state warps update H while
//     the Y warps compute Y from the copy, so a tile takes the longer of
//     the two, not the sum.
//   - Tiles of T = 64 steps that start again at every chunk start, so a
//     tile never spans a reset of cumlog and exp(cum_i - cum_j) is exactly
//     the reference's. With c0 = cum at the step before the tile (0 at a
//     chunk start), a tile computes G = C B^T, P = G o L masked (j <= i)
//     before the exponent (exp above the diagonal can overflow, and
//     inf * 0 is NaN), Y = P X + diag(exp(cum - c0)) C H^T, and H <- H
//     exp(cum_last - c0) + (X o exp(cum_last - cum))^T B.
//   - Two warps take each 16-row tile of Y: the causal triangle gives row
//     tile r 2r + 2 strips of 8 columns, and the first warp takes C H^T
//     and the first strips, the second the rest, so the busiest warp does
//     about half of what one warp a row tile would; the second hands its
//     partial Y over in shared memory. A warp computes G for all its
//     strips at once (independent accumulators); each G fragment becomes P
//     and goes straight into P X as an A fragment (the accumulator's
//     columns 2q, 2q+1 are taken as k slots q, q+4, and X is read in the
//     same order), so P never leaves registers. The state update reads X^T
//     and B in that permuted k order too, which keeps the shared-memory
//     reads free of bank conflicts.
//   - G = C B^T is mma.sync m16n8k16 on bf16 B and C as they are (exact
//     products, f32 sums). The other three products are m16n8k8 TF32 with
//     f32 accumulators, each f32 operand split into TF32 hi + lo terms
//     (3xTF32: hi*hi + hi*lo + lo*hi, about 2^-21 of each product): P X
//     takes 3 products a tile, C H^T and the state update 2 each (bf16 B
//     and C are exact in TF32). One TF32 rounding (2^-11) of xbar, P and H
//     puts y some 3e-3 of its size from f32 at zamba2's shape (the sums
//     cancel: their terms are much larger than y), past the 2e-4 the
//     kernel is held to; tests/test_torch_ssm_design.py emulates both.
//     H itself stays f32.
//   - The tiles' xbar (T x 32 f32), B, C (T x ds bf16) and cumlog stream
//     through a ring of 3 shared-memory stages with cp.async, two tiles
//     ahead of the one computed; steps past S are zero-filled (NaN in
//     unwritten shared memory times 0 would be NaN).
//
// ssm_scan_kernel (f32 B/C): the checking path (the f32 kernel tests at
//   2e-4 and the f32 path check), computed as its recurrence (the
//   semantics of ssm_scan_ref), h_t = a_t h_{t-1} + xbar_t^T B_t,
//   y_t = h_t C_t, a_t = exp(cum_t - cum_{t-1}) (cum_{t-1} = 0 at a chunk
//   start). Bound: operations, 4 BH S hd ds f32 flops on CUDA cores
//   (67 TFLOP/s). Grid (BH, hd / 16), 256 threads, 16 threads a row of h;
//   thread q of a row keeps the states s = q, q + 16, ... in registers;
//   the inputs of 32 steps are staged in shared memory, y_t[p] is summed
//   across the 16 threads of the row with shuffles and leaves as one
//   coalesced write a tile.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

// -- bf16 B/C: the chunked form on the tensor cores -----------------------------

constexpr int kTcT = 64;           // steps a tile
constexpr int kTcP = 32;           // rows of the state a block
constexpr int kTcYWarps = 8;       // Y: 2 a row tile of 16 steps
constexpr int kTcHWarps = 4;       // the state update
constexpr int kTcWarps = kTcYWarps + kTcHWarps;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcStages = 3;       // tiles in the shared-memory ring
constexpr int kXS = kTcP + 4;      // f32 a staged xbar row (bank spread)
constexpr int kCumN = kTcT + 4;    // staged cumlog: c0, then T steps

template <int DS>
struct SsmTcLayout {
  static constexpr int kBS = DS + 8;                 // bf16 a staged B/C row
  static constexpr int kHS = DS + 8;                 // TF32 a staged H row
  static constexpr int kXBytes = kTcT * kXS * 4;
  static constexpr int kBCBytes = kTcT * kBS * 2;
  static constexpr int kStage = kXBytes + 2 * kBCBytes + kCumN * 4;
  // the second warps' partial Y: 16 rows x kTcP f32 a row tile
  static constexpr int kYBytes = (kTcYWarps / 2) * 16 * kTcP * 4;
  static constexpr int kHOff = kTcStages * kStage;   // sH (hi, lo), sY
  static constexpr int kHN2 = kTcP * kHS;            // words a term of sH
  static constexpr int kBytes = kHOff + 2 * kHN2 * 4 + kYBytes;
  // the state's 16 x 8 mma tiles, split evenly over the state warps
  static constexpr int kHTiles = (kTcP / 16) * (DS / 8);
  static constexpr int kHN = (kHTiles + kTcHWarps - 1) / kTcHWarps;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; zero-fill the destination when !pred (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f32 -> TF32, rounded to nearest (ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// f32 -> TF32 hi + lo with x = hi + lo to about 2^-22 of x (3xTF32)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// a bf16 as the f32 (and TF32) bits of the same value: exact
__device__ __forceinline__ uint32_t bf16_bits(const uint16_t* p) {
  return static_cast<uint32_t>(*p) << 16;
}
// the end of the tile starting at t0: 64 steps, the chunk's end or S
__device__ __forceinline__ int tile_end(int t0, int S, int chunk) {
  return min(min(t0 + kTcT, (t0 / chunk + 1) * chunk), S);
}

template <int DS>
struct Stage {
  float* x;          // [kTcT][kXS]
  uint16_t* b;       // [kTcT][kBS] bf16 bits
  uint16_t* c;
  float* cum;        // [kCumN]: c0, then cum of the tile's steps

  __device__ Stage(unsigned char* base) {
    using L = SsmTcLayout<DS>;
    x = reinterpret_cast<float*>(base);
    b = reinterpret_cast<uint16_t*>(base + L::kXBytes);
    c = reinterpret_cast<uint16_t*>(base + L::kXBytes + L::kBCBytes);
    cum = reinterpret_cast<float*>(base + L::kXBytes + 2 * L::kBCBytes);
  }
};

// Start the copies of the tile [t0, t1) into st (steps past t1 zero).
template <int DS>
__device__ __forceinline__ void load_tile(const Stage<DS>& st,
                                          const float* xb,
                                          const __nv_bfloat16* Bb,
                                          const __nv_bfloat16* Cb,
                                          const float* cb, int t0, int t1,
                                          int chunk, int hd, int p0) {
  constexpr int kBS = SsmTcLayout<DS>::kBS;
  constexpr int kXC = kTcP / 4;                   // 16-byte chunks an x row
  constexpr int kCC = DS / 8;                     // 16-byte chunks a B/C row
  const int n = t1 - t0;
  for (int i = threadIdx.x; i < kTcT * kXC; i += kTcThreads) {
    const int r = i / kXC, p = p0 + 4 * (i % kXC);
    const bool ok = r < n && p < hd;
    cp_async16(st.x + r * kXS + 4 * (i % kXC),
               ok ? xb + static_cast<size_t>(t0 + r) * hd + p : xb, ok);
  }
  for (int i = threadIdx.x; i < kTcT * kCC; i += kTcThreads) {
    const int r = i / kCC, cc = i % kCC;
    const bool ok = r < n;
    const size_t off = ok ? static_cast<size_t>(t0 + r) * DS + 8 * cc : 0;
    cp_async16(st.b + r * kBS + 8 * cc, Bb + off, ok);
    cp_async16(st.c + r * kBS + 8 * cc, Cb + off, ok);
  }
  // cum[0] = cumlog at t0 - 1 inside a chunk, 0 at a chunk start
  for (int i = threadIdx.x; i < kTcT + 1; i += kTcThreads) {
    const bool ok = i == 0 ? t0 % chunk != 0 : i - 1 < n;
    cp_async4(st.cum + i, ok ? cb + t0 + i - 1 : cb, ok);
  }
}

template <int DS>
__global__ void __launch_bounds__(kTcThreads, 1)
ssm_tc_kernel(const float* __restrict__ xbar,
              const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm,
              const float* __restrict__ cum, float* __restrict__ y,
              float* __restrict__ h_out, int S, int hd, int group,
              int chunk) {
  using L = SsmTcLayout<DS>;
  constexpr int kBS = L::kBS, kHS = L::kHS, kHN = L::kHN;
  constexpr int kKS = DS / 8;        // k-steps over the state
  constexpr int kKT = kTcT / 8;      // 8-step column strips of a tile
  constexpr int kPN = kTcP / 8;      // n-tiles of y's state rows
  extern __shared__ __align__(16) unsigned char smem[];
  // H as TF32 hi terms, then the lo terms kHN2 words on
  uint32_t* sH = reinterpret_cast<uint32_t*>(smem + L::kHOff);
  float* sY = reinterpret_cast<float*>(smem + L::kHOff + 2 * L::kHN2 * 4);

  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kTcP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bc = bh / group;
  const float* xb = xbar + static_cast<size_t>(bh) * S * hd;
  const __nv_bfloat16* Bb = Bm + static_cast<size_t>(bc) * S * DS;
  const __nv_bfloat16* Cb = Cm + static_cast<size_t>(bc) * S * DS;
  const float* cb = cum + static_cast<size_t>(bh) * S;
  float* yb = y + static_cast<size_t>(bh) * S * hd;

  // a state warp's tiles of H: kHN neighbouring n-tiles of one m-tile
  // (none for a warp past the last tile)
  const int ht0 = (warp - kTcYWarps) * kHN;
  const bool hown = warp >= kTcYWarps && ht0 < L::kHTiles;
  const int pr = 16 * (ht0 / (DS / 8)) + g;     // state rows pr, pr + 8
  const int hs0 = 8 * (ht0 % (DS / 8));         // first state column
  float hacc[kHN][4];
#pragma unroll
  for (int j = 0; j < kHN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;
  for (int i = threadIdx.x; i < 2 * L::kHN2; i += kTcThreads) sH[i] = 0u;

  // the ring: tiles 0 and 1 now, each later tile two tiles ahead
  int tl = 0;                          // the next tile to load
  for (int k = 0; k < kTcStages - 1; ++k) {
    if (tl < S) {
      load_tile(Stage<DS>(smem + k * L::kStage), xb, Bb, Cb, cb, tl,
                tile_end(tl, S, chunk), chunk, hd, p0);
      tl = tile_end(tl, S, chunk);
    }
    cp_async_commit();
  }
  int buf = 0;
  for (int t0 = 0; t0 < S; buf = buf == kTcStages - 1 ? 0 : buf + 1) {
    const int t1 = tile_end(t0, S, chunk);
    if (tl < S) {
      const int ld = buf == 0 ? kTcStages - 1 : buf - 1;  // the last tile's
      load_tile(Stage<DS>(smem + ld * L::kStage), xb, Bb, Cb, cb, tl,
                tile_end(tl, S, chunk), chunk, hd, p0);
      tl = tile_end(tl, S, chunk);
    }
    cp_async_commit();                 // (empty near the end)
    cp_async_wait<kTcStages - 1>();    // this tile has landed
    __syncthreads();                   // ... for every thread; sH too
    const Stage<DS> st(smem + buf * L::kStage);
    const int n = t1 - t0;
    const float c0 = st.cum[0], clast = st.cum[n];

    // -- Y for tile rows ia = i0 + g and ib = ia + 8 of row tile rt, by
    // two warps: the first takes C H^T and the first `split` 8-column
    // strips of P X, the second the other strips (the causal triangle
    // gives row tile rt 2 rt + 2 strips), so the work is near even. The
    // state dim s is the k of C H^T and C B^T; k slots q and q + 4 take
    // s = 2q and 2q + 1, so each pair of operands is one 32-bit load.
    const bool ywarp = warp < kTcYWarps;
    const int rt = warp & 3, second = (warp >> 2) & 1;
    const int i0 = 16 * rt;
    const int ia = i0 + g, ib = ia + 8;
    float yacc[kPN][4];
#pragma unroll
    for (int pn = 0; pn < kPN; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pn][e] = 0.f;
    if (ywarp && i0 < n) {
      // C rows ia, ib: the bf16 pairs (s = 8 ks + 2q, + 1) are the A
      // fragments of the bf16 product (k 16) as they are, and give the
      // TF32 ones of C H^T (k 8) as their two halves
      uint32_t cw[kKS][2];
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        cw[ks][0] = *reinterpret_cast<const uint32_t*>(
            st.c + ia * kBS + 8 * ks + 2 * q);
        cw[ks][1] = *reinterpret_cast<const uint32_t*>(
            st.c + ib * kBS + 8 * ks + 2 * q);
      }
      const int nkt = min(2 * rt + 2, (n + 7) / 8);
      // the 64 products of C H^T weigh about 4 strips (16 products each)
      const int split = max(0, (nkt - 4) / 2);
      const int kt0 = second ? split : 0, kt1 = second ? nkt : split;
      // G = C B^T for the warp's strips, on bf16 B and C as they are (the
      // products are exact and summed in f32, as in TF32): independent
      // accumulators, so the strips' products overlap
      float gacc[kKT][4];
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[kt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS / 2; ++kk) {
        const uint32_t a[4] = {cw[2 * kk][0], cw[2 * kk][1],
                               cw[2 * kk + 1][0], cw[2 * kk + 1][1]};
#pragma unroll
        for (int kt = 0; kt < kKT; ++kt) {
          if (kt < kt0 || kt >= kt1) continue;
          const uint16_t* br = st.b + (8 * kt + g) * kBS + 16 * kk + 2 * q;
          mma_bf16(gacc[kt], a, *reinterpret_cast<const uint32_t*>(br),
                   *reinterpret_cast<const uint32_t*>(br + 8));
        }
      }
      const float cia = st.cum[1 + ia], cib = st.cum[1 + ib];
      if (!second) {
        // inter-tile: C H^T, each row decayed by exp(cum_i - c0)
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          const uint32_t a[4] = {cw[ks][0] << 16, cw[ks][1] << 16,
                                 cw[ks][0] & 0xffff0000u,
                                 cw[ks][1] & 0xffff0000u};
#pragma unroll
          for (int pn = 0; pn < kPN; ++pn) {
            const uint32_t* hr = sH + (8 * pn + g) * kHS + 8 * ks + 2 * q;
            const uint2 hl = *reinterpret_cast<const uint2*>(hr + L::kHN2);
            const uint2 hh = *reinterpret_cast<const uint2*>(hr);
            mma_tf32(yacc[pn], a, hl.x, hl.y);
            mma_tf32(yacc[pn], a, hh.x, hh.y);
          }
        }
        const float ea = ia < n ? expf(cia - c0) : 0.f;
        const float eb = ib < n ? expf(cib - c0) : 0.f;
#pragma unroll
        for (int pn = 0; pn < kPN; ++pn) {
          yacc[pn][0] *= ea;
          yacc[pn][1] *= ea;
          yacc[pn][2] *= eb;
          yacc[pn][3] *= eb;
        }
      }
      // intra-tile: P = G o L masked before the exponent (the fast exp's
      // error, a few f32 ulps at these arguments, is far inside the
      // tolerance), Y += P X in 3xTF32
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        if (kt < kt0 || kt >= kt1) continue;
        const int ja = 8 * kt + 2 * q, jb = ja + 1;
        const float cja = st.cum[1 + ja], cjb = st.cum[1 + jb];
        // accumulator (row, col) -> A fragment (row, k slot): col 2q is
        // slot q, col 2q + 1 slot q + 4
        const float pv[4] = {
            ja <= ia && ia < n ? gacc[kt][0] * __expf(cia - cja) : 0.f,
            ja <= ib && ib < n ? gacc[kt][2] * __expf(cib - cja) : 0.f,
            jb <= ia && ia < n ? gacc[kt][1] * __expf(cia - cjb) : 0.f,
            jb <= ib && ib < n ? gacc[kt][3] * __expf(cib - cjb) : 0.f};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(pv[e], ah[e], al[e]);
#pragma unroll
        for (int pn = 0; pn < kPN; ++pn) {
          uint32_t xh0, xl0, xh1, xl1;
          tf32_split(st.x[ja * kXS + 8 * pn + g], xh0, xl0);
          tf32_split(st.x[jb * kXS + 8 * pn + g], xh1, xl1);
          mma_tf32(yacc[pn], al, xh0, xh1);
          mma_tf32(yacc[pn], ah, xl0, xl1);
          mma_tf32(yacc[pn], ah, xh0, xh1);
        }
      }
    }
    if (ywarp && second) {             // hand the partial Y over
#pragma unroll
      for (int pn = 0; pn < kPN; ++pn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sY[((rt * kPN + pn) * 4 + e) * 32 + lane] = yacc[pn][e];
    }

    // -- state: H <- H exp(clast - c0) + (X o exp(clast - cum))^T B, with
    // the k steps (tile rows) in the order 2q, 2q + 1
    if (hown) {
      const float eh = expf(clast - c0);
#pragma unroll
      for (int j = 0; j < kHN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= eh;
      const int nks = (n + 7) / 8;
#pragma unroll
      for (int ks = 0; ks < kKT; ++ks) {
        if (ks >= nks) break;
        const int ia = 8 * ks + 2 * q, ib = ia + 1;
        const float da = ia < n ? __expf(clast - st.cum[1 + ia]) : 0.f;
        const float db = ib < n ? __expf(clast - st.cum[1 + ib]) : 0.f;
        const float xd[4] = {st.x[ia * kXS + pr] * da,
                             st.x[ia * kXS + pr + 8] * da,
                             st.x[ib * kXS + pr] * db,
                             st.x[ib * kXS + pr + 8] * db};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(xd[e], ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < kHN; ++j) {
          const int s = hs0 + 8 * j + g;
          const uint32_t b0 = bf16_bits(st.b + ia * kBS + s);
          const uint32_t b1 = bf16_bits(st.b + ib * kBS + s);
          mma_tf32(hacc[j], al, b0, b1);
          mma_tf32(hacc[j], ah, b0, b1);
        }
      }
    }
    __syncthreads();                   // every warp is done with sH and st
    if (ywarp && !second && i0 < n) {
#pragma unroll
      for (int pn = 0; pn < kPN; ++pn) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yacc[pn][e] += sY[((rt * kPN + pn) * 4 + e) * 32 + lane];
        const int p = p0 + 8 * pn + 2 * q;
        if (p >= hd) continue;
        if (ia < n)
          *reinterpret_cast<float2*>(yb + static_cast<size_t>(t0 + ia) * hd + p) =
              make_float2(yacc[pn][0], yacc[pn][1]);
        if (ib < n)
          *reinterpret_cast<float2*>(yb + static_cast<size_t>(t0 + ib) * hd + p) =
              make_float2(yacc[pn][2], yacc[pn][3]);
      }
    }
    if (hown) {
#pragma unroll
      for (int j = 0; j < kHN; ++j) {
        const int s = hs0 + 8 * j + 2 * q;
        uint32_t hh[4], hl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(hacc[j][e], hh[e], hl[e]);
        *reinterpret_cast<uint2*>(sH + pr * kHS + s) = make_uint2(hh[0], hh[1]);
        *reinterpret_cast<uint2*>(sH + (pr + 8) * kHS + s) =
            make_uint2(hh[2], hh[3]);
        *reinterpret_cast<uint2*>(sH + L::kHN2 + pr * kHS + s) =
            make_uint2(hl[0], hl[1]);
        *reinterpret_cast<uint2*>(sH + L::kHN2 + (pr + 8) * kHS + s) =
            make_uint2(hl[2], hl[3]);
      }
    }
    t0 = t1;
  }
  cp_async_wait<0>();

  if (hown) {
#pragma unroll
    for (int j = 0; j < kHN; ++j) {
      const int s = hs0 + 8 * j + 2 * q;
      const int p = p0 + pr;
      if (p < hd)
        *reinterpret_cast<float2*>(h_out + (static_cast<size_t>(bh) * hd + p) * DS + s) =
            make_float2(hacc[j][0], hacc[j][1]);
      if (p + 8 < hd)
        *reinterpret_cast<float2*>(h_out + (static_cast<size_t>(bh) * hd + p + 8) * DS + s) =
            make_float2(hacc[j][2], hacc[j][3]);
    }
  }
}

template <int DS>
int launch_tc(const float* xbar, const void* B, const void* C,
              const float* cum, float* y, float* h, int bh, int S, int hd,
              int group, int chunk, cudaStream_t stream) {
  constexpr int kBytes = SsmTcLayout<DS>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_tc_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (hd + kTcP - 1) / kTcP);
  ssm_tc_kernel<DS><<<grid, kTcThreads, kBytes, stream>>>(
      xbar, static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), cum, y, h, S, hd, group, chunk);
  return 0;
}

// -- f32 B/C: the recurrence on CUDA cores ---------------------------------------

constexpr int kRows = 16;          // rows of hd per block
constexpr int kTPR = 16;           // threads per row
constexpr int kThreads = kRows * kTPR;
constexpr int kT = 32;             // steps per staged tile

template <int DS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ xbar, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ cum,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int hd, int group, int chunk) {
  constexpr int kNS = DS / kTPR;   // states per thread
  __shared__ float sx[kT][kRows];
  __shared__ float sB[kT][DS];
  __shared__ float sC[kT][DS];
  __shared__ float sa[kT];
  __shared__ float sy[kT][kRows];

  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kRows;
  const int r = threadIdx.x / kTPR;   // row within the block
  const int q = threadIdx.x % kTPR;   // state slice within the row
  const int bc = bh / group;
  const float* xb = xbar + static_cast<size_t>(bh) * S * hd;
  const float* Bb = Bm + static_cast<size_t>(bc) * S * DS;
  const float* Cb = Cm + static_cast<size_t>(bc) * S * DS;
  const float* cb = cum + static_cast<size_t>(bh) * S;

  float h[kNS];
#pragma unroll
  for (int m = 0; m < kNS; ++m) h[m] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    for (int i = threadIdx.x; i < kT * DS; i += kThreads) {
      const int t = i / DS, s = i % DS;
      const bool in = t < n;
      const size_t off = static_cast<size_t>(t0 + t) * DS + s;
      sB[t][s] = in ? Bb[off] : 0.f;
      sC[t][s] = in ? Cb[off] : 0.f;
    }
    for (int i = threadIdx.x; i < kT * kRows; i += kThreads) {
      const int t = i / kRows, c = i % kRows;
      const int p = p0 + c;
      sx[t][c] = (t < n && p < hd)
                     ? xb[static_cast<size_t>(t0 + t) * hd + p] : 0.f;
    }
    if (threadIdx.x < kT) {
      const int t = t0 + threadIdx.x;
      float a = 1.f;
      if (threadIdx.x < n) {
        const float prev = (t % chunk == 0) ? 0.f : cb[t - 1];
        a = expf(cb[t] - prev);
      }
      sa[threadIdx.x] = a;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float a = sa[t];
      const float x = sx[t][r];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kNS; ++m) {
        const int s = q + kTPR * m;
        h[m] = fmaf(a, h[m], x * sB[t][s]);
        acc = fmaf(h[m], sC[t][s], acc);
      }
#pragma unroll
      for (int off = kTPR / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (q == 0) sy[t][r] = acc;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n * kRows; i += kThreads) {
      const int t = i / kRows, c = i % kRows;
      const int p = p0 + c;
      if (p < hd) y[(static_cast<size_t>(bh) * S + t0 + t) * hd + p] = sy[t][c];
    }
    __syncthreads();  // the next tile overwrites the staged inputs and sy
  }

  const int p = p0 + r;
  if (p < hd) {
#pragma unroll
    for (int m = 0; m < kNS; ++m)
      h_out[(static_cast<size_t>(bh) * hd + p) * DS + q + kTPR * m] = h[m];
  }
}

template <int DS>
int launch_f32(const float* xbar, const void* B, const void* C,
               const float* cum, float* y, float* h, int bh, int S, int hd,
               int group, int chunk, cudaStream_t stream) {
  const dim3 grid(bh, (hd + kRows - 1) / kRows);
  ssm_scan_kernel<DS><<<grid, kThreads, 0, stream>>>(
      xbar, static_cast<const float*>(B), static_cast<const float*>(C), cum,
      y, h, S, hd, group, chunk);
  return 0;
}

int launch(bool tc, const float* xbar, const void* B, const void* C, const float* cum,
           float* y, float* h, int bh, int S, int hd, int ds, int group,
           int chunk, cudaStream_t stream) {
#define REPRO_SSM_DS(DS)                                                     \
  case DS:                                                                   \
    return tc ? launch_tc<DS>(xbar, B, C, cum, y, h, bh, S, hd, group,      \
                               chunk, stream)                                \
               : launch_f32<DS>(xbar, B, C, cum, y, h, bh, S, hd, group,     \
                                chunk, stream);
  switch (ds) {
    REPRO_SSM_DS(16)
    REPRO_SSM_DS(32)
    REPRO_SSM_DS(64)
    REPRO_SSM_DS(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSM_DS
}

}  // namespace
}  // namespace repro

extern "C" int repro_ssm_scan(const void* xbar, const void* B, const void* C,
                              const void* cumlog, void* y, void* h, int bh,
                              int bh_bc, int S, int hd, int ds, int chunk,
                              int dtype, void* stream) {
  if (bh_bc <= 0 || bh % bh_bc != 0 || chunk <= 0 || S <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bh_bc;
  const float* xb = static_cast<const float*>(xbar);
  const float* cl = static_cast<const float*>(cumlog);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16 && hd % 4 == 0) {
    rc = repro::launch(true, xb, B, C, cl, yo, ho, bh, S, hd, ds, group, chunk, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch(false, xb, B, C, cl, yo, ho, bh, S, hd, ds, group, chunk, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
