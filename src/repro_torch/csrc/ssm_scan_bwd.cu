// ssm_scan_bwd: the gradient of ssm_scan (csrc/ssm_scan.cu), the Mamba2
// (SSD) selective scan. Inputs: the forward's xbar (BH, S, hd) f32, B, C
// (BH_bc, S, ds) bf16 or f32 (row bh reads B/C row bh / (BH / BH_bc)),
// cumlog (BH, S) f32 reset every `chunk` steps; the gradients dy (BH, S,
// hd) f32 of y and dh (BH, hd, ds) f32 of the final state (zeros when
// the caller drops the state, as training does; carried in as the
// initial reverse state). Writes dxbar (BH, S, hd) f32, dB and dC
// (BH_bc, S, ds) in B's dtype (summed over the heads of a group) and
// dcumlog (BH, S) f32. hd is a multiple of 4 and every pointer 16-byte
// aligned (the wrapper pads and copies to make it so).
//
// The gradient of the Pallas TPU kernel ssm_scan / _ssm_kernel
// (src/repro/kernels/ssm_scan.py:49, body :18); the JAX package has no
// backward kernel and differentiates its jnp model with XLA. Per chunk c
// of n steps (the last may be short), with tot = cum_{n-1}, the state H_c
// at the chunk's start and G_c the gradient of the state at its end:
//   L_ij = exp(cum_i - cum_j) (j <= i), P = (C B^T) o L, dP = dY X^T,
//   M = dP o L, R = dP o P;
//   dX = P^T dY + diag(exp(tot - cum)) B G^T
//   dC = M B + diag(exp(cum)) dY H            (the second term W)
//   dB = M^T C + diag(exp(tot - cum)) X G     (the second term V)
//   dcum_i = sum_j R_ij - sum_k R_ki + C_i . W_i - B_i . V_i
//            + [i = n - 1] (sum_j B_j . V_j + exp(tot) sum G o H)
//   G_{c-1} = exp(tot) G_c + sum_i exp(cum_i) dy_i^T C_i,  G_{nc-1} = dh.
// Every exp(cum_i - cum_j) has its argument masked to -inf before the
// exponent where j > i or a step lies past the chunk, as ssm_tc_kernel
// does: above the diagonal the argument can pass ~88 and overflow, and a
// mask after the exponent gives 0 * inf = NaN in the gradient (which is
// what JAX's ssm_block and the Pallas kernel give there).
//
// Bound on an H100: operations on the tensor cores. Every product runs
// on mma.sync m16n8k8 in TF32 with f32 accumulators, each f32 operand
// split into TF32 hi + lo (3xTF32: hi*hi + hi*lo + lo*hi, about 2^-20 of
// each product; one TF32 rounding misses the 2e-5 the f32 gradients are
// held to); a bf16 operand (B, C) is exact in TF32, so its products take
// two passes. C B^T on bf16 B/C is mma.sync m16n8k16 bf16 (exact
// products, f32 sums), in 3xTF32 for f32 B/C. Kernels:
// - ssm_bwd_prep_kernel, grid (BH + BH_bc, nc): a block a (head, chunk)
//   forms the chunk's own state terms, U_c = X^T diag(exp(tot - cum)) B
//   and V_c = dY^T diag(exp(cum)) C (hd x ds, over the chunk's steps in
//   tiles of 64); a block a (B/C group, chunk) forms C B^T once for the
//   group's heads, as 64 x 64 tiles on and below the diagonal, into a
//   scratch of (BH_bc, nc, tiles, 64, 64) f32 (5.2 MB at zamba2's shape,
//   resident in L2) that each head's chunk block reads: one block a
//   (group, chunk) would leave 32 blocks for the card, and a block that
//   served several heads would form it once for each of its heads.
// - ssm_bwd_carry_kernel, grid (BH, hd ds / 256, 2): the only serial
//   part, over the nc chunks, elementwise on the (hd, ds) state: H_{c+1}
//   = exp(tot_c) H_c + U_c forward and G_{c-1} = exp(tot_c) G_c + V_c in
//   reverse from dh, H_c and G_c written over U_c and V_c.
// - ssm_bwd_chunk_kernel, grid (BH, nc), 8 warps, a block a (head,
//   chunk), the chunk in tiles of 64 steps, in one sweep: the column
//   tiles j in order, and for each the row tiles i >= j from the last
//   down to j. A tile pair loads C B^T from the scratch and forms dY X^T
//   once (a warp 16 rows x 32 columns), then P, M and R in registers, the
//   row and column sums of R, P and M to shared memory; then dX_j +=
//   P^T dY_i and dB_j += M^T C_i into the column tile's accumulators,
//   held in registers across the 8 warps for the whole sweep of i, and
//   dC_i += M B_j and the row sums of R, added into this head's dC
//   partial and dcum rows in global memory (read and written by the
//   thread that owns them, in the order of j, so resident in L2 and
//   valid for any chunk, where a resident shared copy of a long chunk's
//   dC would not fit). The last pair of a column tile is (j, j), after
//   which tile j's rows and columns are complete: the state terms (G,
//   then H, staged in the shared memory of P and M) finish dX_j, dB_j,
//   dC_j and dcum_j. Row tiles, C B^T and the column tiles stream by
//   cp.async (the next pair's C B^T while its products run, its row
//   tile while dC's runs); ragged rows and columns past hd are
//   zero-filled.
// - sum_partials_kernel (common.cuh): dB and dC, the partials summed over
//   the heads of a group in order, cast to B's dtype. No float atomics
//   anywhere: two calls give the same bits.
// At zamba2-1.2b's training microbatch (BH 128 = 2 x 64 heads, S 4096,
// hd = ds = 64, chunk 256, bf16 B/C) chip_smoke.py counts 56 GFLOP
// (ssm_bwd_flops), 0.84 ms at the 67 TFLOP/s of the CUDA cores, 0.28 ms
// at the tensor cores' rates as the products run (3 passes at 495
// TFLOP/s where both operands are f32, 2 where one is bf16, C B^T in
// bf16 at 989); bytes 0.41 GB, 0.12 ms. The chunk pass keeps 2 blocks
// (16 warps) an SM at hd = ds = 64 with bf16 B/C (113.8 KB of shared
// memory each); f32 B/C and hd or ds 128 run one. hd is at most 128.
// Measured there on an H100 80GB HBM3 (700 W): 1.46 ms (the first, SIMT
// design 7.43 ms), 0.19 of the tensor-core bound; in a train step a
// launch is 1.13 ms chunk pass + 0.16 prep + 0.07 carry + 0.10 sums. By
// a count of the source, the chunk pass issues some 2,000 instructions a
// warp and tile pair beside its 320 mma (the splits, the fragments'
// loads, P, M and R), so the issue slots more than the tensor cores are
// what it waits on; the per-head partials of dB and dC (0.27 GB written
// and read) bound the sums (PERF.md, row 4b).
// tests/test_torch_scan_grad.py emulates this on the CPU.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;             // steps a tile
constexpr int kTS = kT + 8;        // f32 a row of a staged 64 x 64 tile
constexpr int kCarry = 8;          // chunks a carry thread loads at a time

// bf16 values are exact in TF32: their products need no lo term
template <typename T>
struct ExactTF32 { static constexpr bool value = false; };
template <>
struct ExactTF32<__nv_bfloat16> { static constexpr bool value = true; };

// two neighbouring elements as f32 (a bf16 pair is one 32-bit word)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x = hi + lo exactly: hi keeps x's sign, exponent and top 10 mantissa
// bits (a TF32 value), lo the rest, of which the tensor cores read the
// top 10 bits (an f32 operand's low 13 bits are not read), so that a
// 3xTF32 product carries about 2^-20 of each term. Two instructions; a
// rounded split (cvt.rna for each part) would cost several more on every
// operand and buy a bit no gradient here needs.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x as TF32 hi + lo, or as it is (lo 0) when it is exact in TF32
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    tf32_split(x, hi, lo);
  }
}

// d += a b with a and b each given as hi + lo: lo*hi and hi*lo (skipped
// for an exact operand, whose lo is 0), then hi*hi
template <bool kExA, bool kExB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if (!kExA) mma_tf32(d, al, bh0, bh1);
  if (!kExB) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The A fragment (rows g, g + 8; k slots q, q + 4) of four values
template <bool kExact>
__device__ __forceinline__ void frag_a(float a0, float a1, float a2, float a3,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  split<kExact>(a0, h[0], l[0]);
  split<kExact>(a1, h[1], l[1]);
  split<kExact>(a2, h[2], l[2]);
  split<kExact>(a3, h[3], l[3]);
}

// -- staging by cp.async: 64 steps from step s0 of a chunk of n, zero past n --

// f32 rows of W floats (hd, padded to W), `w` of them real, stride DST
template <int W, int DST>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int s0, int n, int w) {
  constexpr int kC = W / 4;                 // 16-byte chunks a row
  for (int e = threadIdx.x; e < kT * kC; e += kThreads) {
    const int r = e / kC, c = 4 * (e % kC);
    const bool ok = s0 + r < n && c < w;
    cp_async16(smem_addr(dst + r * DST + c),
               ok ? src + static_cast<size_t>(s0 + r) * w + c : src, ok);
  }
}

// B or C rows of DS elements, stride DST
template <typename Tin, int DS, int DST>
__device__ __forceinline__ void load_bc(Tin* dst, const Tin* src, int s0,
                                        int n) {
  constexpr int kE = 16 / static_cast<int>(sizeof(Tin));
  constexpr int kC = DS / kE;
  for (int e = threadIdx.x; e < kT * kC; e += kThreads) {
    const int r = e / kC, c = kE * (e % kC);
    const bool ok = s0 + r < n;
    cp_async16(smem_addr(dst + r * DST + c),
               ok ? src + static_cast<size_t>(s0 + r) * DS + c : src, ok);
  }
}

__device__ __forceinline__ void load_cum(float* dst, const float* src, int s0,
                                         int n) {
  for (int e = threadIdx.x; e < kT; e += kThreads) {
    const bool ok = s0 + e < n;
    cp_async4(smem_addr(dst + e), ok ? src + s0 + e : src, ok);
  }
}

// -- the prep pass: each chunk's state terms; C B^T once a group -----------------

template <typename Tin, int HP, int DS>
struct PrepLayout {
  static constexpr int kXS = HP + 8, kBS = DS + 8;
  static constexpr int kE = static_cast<int>(sizeof(Tin));
  static constexpr int kX = 0, kB = kX + kT * kXS * 4,
                       kDY = kB + kT * kBS * kE, kC = kDY + kT * kXS * 4,
                       kCum = kC + kT * kBS * kE, kWt = kCum + kT * 4,
                       kBytes = kWt + 2 * kT * 4;
};

template <typename Tin, int HP, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_bwd_prep_kernel(const float* __restrict__ xbar,
                    const Tin* __restrict__ Bm, const Tin* __restrict__ Cm,
                    const float* __restrict__ cum,
                    const float* __restrict__ dy, float* __restrict__ hs,
                    float* __restrict__ gs, float* __restrict__ cbs, int BH,
                    int S, int hd, int group, int chunk, int nc, int ntt) {
  using L = PrepLayout<Tin, HP, DS>;
  constexpr bool kEx = ExactTF32<Tin>::value;
  constexpr int XS = L::kXS, BS = L::kBS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem + L::kX);
  Tin* sB = reinterpret_cast<Tin*>(smem + L::kB);
  float* sDY = reinterpret_cast<float*>(smem + L::kDY);
  Tin* sC = reinterpret_cast<Tin*>(smem + L::kC);
  float* scum = reinterpret_cast<float*>(smem + L::kCum);
  float* swt = reinterpret_cast<float*>(smem + L::kWt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int c = blockIdx.y;
  const int t0 = c * chunk, n = min(chunk, S - t0);

  if (static_cast<int>(blockIdx.x) >= BH) {
    // -- C B^T of a group: tiles (ti, tj <= ti) of the chunk ---------------------
    const int bc = blockIdx.x - BH;
    const Tin* Bb = Bm + (static_cast<size_t>(bc) * S + t0) * DS;
    const Tin* Cb = Cm + (static_cast<size_t>(bc) * S + t0) * DS;
    float* out = cbs + (static_cast<size_t>(bc) * nc + c) * ntt * kT * kT;
    const int nt = (n + kT - 1) / kT;
    const int ra = 16 * wr + g;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tj = 0; tj <= ti; ++tj) {
        __syncthreads();             // the previous tile's reads are done
        load_bc<Tin, DS, BS>(sC, Cb, ti * kT, n);
        load_bc<Tin, DS, BS>(sB, Bb, tj * kT, n);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
        if constexpr (kEx) {
          // bf16 as they are: m16n8k16, exact products, f32 sums
          const uint16_t* c16 = reinterpret_cast<const uint16_t*>(sC);
          const uint16_t* b16 = reinterpret_cast<const uint16_t*>(sB);
#pragma unroll
          for (int kk = 0; kk < DS / 16; ++kk) {
            const int s = 16 * kk + 2 * q;
            const uint32_t a[4] = {
                *reinterpret_cast<const uint32_t*>(c16 + ra * BS + s),
                *reinterpret_cast<const uint32_t*>(c16 + (ra + 8) * BS + s),
                *reinterpret_cast<const uint32_t*>(c16 + ra * BS + s + 8),
                *reinterpret_cast<const uint32_t*>(c16 + (ra + 8) * BS + s + 8)};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const uint16_t* br = b16 + (32 * wc + 8 * t + g) * BS + s;
              mma_bf16(acc[t], a, *reinterpret_cast<const uint32_t*>(br),
                       *reinterpret_cast<const uint32_t*>(br + 8));
            }
          }
        } else {
          // f32 B/C in 3xTF32; k slots q, q + 4 take s = 8 ks + 2q, + 1
#pragma unroll
          for (int ks = 0; ks < DS / 8; ++ks) {
            const int s = 8 * ks + 2 * q;
            const float2 c0 = ld2(sC + ra * BS + s);
            const float2 c1 = ld2(sC + (ra + 8) * BS + s);
            uint32_t ah[4], al[4];
            frag_a<false>(c0.x, c1.x, c0.y, c1.y, ah, al);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float2 b = ld2(sB + (32 * wc + 8 * t + g) * BS + s);
              uint32_t bh0, bl0, bh1, bl1;
              tf32_split(b.x, bh0, bl0);
              tf32_split(b.y, bh1, bl1);
              mma3<false, false>(acc[t], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
        float* tile = out + static_cast<size_t>(ti * (ti + 1) / 2 + tj) * kT * kT;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = 32 * wc + 8 * t + 2 * q;
          *reinterpret_cast<float2*>(tile + ra * kT + j) =
              make_float2(acc[t][0], acc[t][1]);
          *reinterpret_cast<float2*>(tile + (ra + 8) * kT + j) =
              make_float2(acc[t][2], acc[t][3]);
        }
      }
    }
    return;
  }

  // -- a head's chunk: U = X^T diag(exp(tot - cum)) B (warps 0-3) and
  // V = dY^T diag(exp(cum)) C (warps 4-7), over the chunk's steps ------------------
  const int bh = blockIdx.x;
  const int bc = bh / group;
  const size_t row0 = static_cast<size_t>(bh) * S + t0;
  const float* xb = xbar + row0 * hd;
  const float* dyb = dy + row0 * hd;
  const Tin* Bb = Bm + (static_cast<size_t>(bc) * S + t0) * DS;
  const Tin* Cb = Cm + (static_cast<size_t>(bc) * S + t0) * DS;
  const float* cb = cum + row0;
  const float tot = cb[n - 1];
  const bool rev = wc == 1;          // this warp forms V
  const float* su = rev ? sDY : sX;
  const Tin* sv = rev ? sC : sB;
  constexpr int kM = HP / 64;        // m-tiles of 16 rows a warp
  constexpr int kN = DS / 8;         // n-tiles of 8 state columns
  float acc[kM][kN][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int t = 0; t < kN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
  for (int s0 = 0; s0 < n; s0 += kT) {
    __syncthreads();                 // the previous tile's reads are done
    load_rows<HP, XS>(sX, xb, s0, n, hd);
    load_rows<HP, XS>(sDY, dyb, s0, n, hd);
    load_bc<Tin, DS, BS>(sB, Bb, s0, n);
    load_bc<Tin, DS, BS>(sC, Cb, s0, n);
    load_cum(scum, cb, s0, n);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < 2 * kT) {              // the weights, 0 past the chunk
      const int t = tid % kT;
      float wt = 0.f;
      if (s0 + t < n) wt = tid < kT ? expf(tot - scum[t]) : expf(scum[t]);
      swt[tid] = wt;
    }
    __syncthreads();
    const float* wts = swt + (rev ? kT : 0);
#pragma unroll 2
    for (int ks = 0; ks < kT / 8; ++ks) {
      const int t = 8 * ks + q;      // k slots q, q + 4: steps t, t + 4
      const float wa = wts[t], wb = wts[t + 4];
      uint32_t vh[kN][2], vl[kN][2];
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        split<kEx>(ld1(sv + t * BS + 8 * nt + g), vh[nt][0], vl[nt][0]);
        split<kEx>(ld1(sv + (t + 4) * BS + 8 * nt + g), vh[nt][1], vl[nt][1]);
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int p = 16 * (wr + 4 * m) + g;
        uint32_t ah[4], al[4];
        frag_a<false>(su[t * XS + p] * wa, su[t * XS + p + 8] * wa,
                      su[(t + 4) * XS + p] * wb, su[(t + 4) * XS + p + 8] * wb,
                      ah, al);
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
          mma3<false, kEx>(acc[m][nt], ah, al, vh[nt][0], vh[nt][1], vl[nt][0],
                           vl[nt][1]);
      }
    }
  }
  float* out = (rev ? gs : hs) +
               (static_cast<size_t>(bh) * nc + c) * hd * DS;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int p = 16 * (wr + 4 * m) + g;
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      const int s = 8 * nt + 2 * q;
      if (p < hd)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(p) * DS + s) =
            make_float2(acc[m][nt][0], acc[m][nt][1]);
      if (p + 8 < hd)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(p + 8) * DS + s) =
            make_float2(acc[m][nt][2], acc[m][nt][3]);
    }
  }
}

// -- the carry over the chunks: H_c forward, G_c in reverse --------------------

__global__ void __launch_bounds__(kThreads)
ssm_bwd_carry_kernel(float* __restrict__ hs, float* __restrict__ gs,
                     const float* __restrict__ cum,
                     const float* __restrict__ dh, int S, int E, int chunk,
                     int nc) {
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= E) return;
  const int bh = blockIdx.x;
  const bool rev = blockIdx.z == 1;
  const float* cb = cum + static_cast<size_t>(bh) * S;
  float* x = (rev ? gs : hs) + static_cast<size_t>(bh) * nc * E + e;
  float v = rev ? dh[static_cast<size_t>(bh) * E + e] : 0.f;
  // kCarry chunks' loads in flight at a time, then their serial updates
  for (int it0 = 0; it0 < nc; it0 += kCarry) {
    float uu[kCarry], gg[kCarry];
#pragma unroll
    for (int m = 0; m < kCarry; ++m) {
      const int c = rev ? nc - 1 - (it0 + m) : it0 + m;
      const bool in = it0 + m < nc;
      uu[m] = in ? x[static_cast<size_t>(c) * E] : 0.f;
      gg[m] = in ? cb[min(S, (c + 1) * chunk) - 1] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kCarry; ++m) {
      if (it0 + m >= nc) break;
      const int c = rev ? nc - 1 - (it0 + m) : it0 + m;
      x[static_cast<size_t>(c) * E] = v;   // the state entering chunk c
      v = fmaf(expf(gg[m]), v, uu[m]);
    }
  }
}

// -- the chunk pass: dX, dB, dC and dcum of a (head, chunk), one sweep ----------

// Shared memory, in bytes: the column tile's X, B, cum; the row tile's
// dY, C, cum; the pair's C B^T; P and M of the pair, later G or H; the
// sums. Rows padded to 8 words past a multiple of 32 (16 bf16 for B, C),
// so that the fragments' reads (a float2 a lane along a row, or a word a
// lane down a column) spread over the banks.
template <typename Tin, int HP, int DS>
struct ChunkLayout {
  static constexpr int kXS = HP + 8, kBS = DS + 8, kGS = DS + 8;
  static constexpr int kE = static_cast<int>(sizeof(Tin));
  static constexpr int kPMBytes = 2 * kT * kTS * 4 > HP * kGS * 4
                                      ? 2 * kT * kTS * 4
                                      : HP * kGS * 4;
  static constexpr int kX = 0, kB = kX + kT * kXS * 4,
                       kCJ = kB + kT * kBS * kE, kDY = kCJ + kT * 4,
                       kC = kDY + kT * kXS * 4, kCI = kC + kT * kBS * kE,
                       kCB = kCI + kT * 4, kPM = kCB + kT * kTS * 4,
                       kSums = kPM + kPMBytes;
  // row sums (2 column halves), column sums (4 row strips), K and C . W
  // (2 halves each) of 64 rows; the warps' sums of G o H
  static constexpr int kBytes = kSums + (10 * kT + kWarps) * 4;
  // two blocks an SM (16 warps) when two fit its 228 KB, 1 KB a block
  // kept by the hardware
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

template <typename Tin, int HP, int DS>
__global__ void __launch_bounds__(kThreads,
                                  ChunkLayout<Tin, HP, DS>::kMinBlocks)
ssm_bwd_chunk_kernel(const float* __restrict__ xbar,
                     const Tin* __restrict__ Bm, const Tin* __restrict__ Cm,
                     const float* __restrict__ cum,
                     const float* __restrict__ dy,
                     const float* __restrict__ hs,
                     const float* __restrict__ gs,
                     const float* __restrict__ cbs, float* __restrict__ dx,
                     float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dcum, int S, int hd, int group,
                     int chunk, int nc, int ntt) {
  using L = ChunkLayout<Tin, HP, DS>;
  constexpr bool kEx = ExactTF32<Tin>::value;
  constexpr int XS = L::kXS, BS = L::kBS, GS = L::kGS;
  constexpr int NP = HP / 16;        // n-tiles of 8 a warp: half of hd
  constexpr int NS = DS / 16;        // ... half of ds
  extern __shared__ __align__(16) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem + L::kX);
  Tin* sB = reinterpret_cast<Tin*>(smem + L::kB);
  float* scj = reinterpret_cast<float*>(smem + L::kCJ);
  float* sDY = reinterpret_cast<float*>(smem + L::kDY);
  Tin* sC = reinterpret_cast<Tin*>(smem + L::kC);
  float* sci = reinterpret_cast<float*>(smem + L::kCI);
  float* sCB = reinterpret_cast<float*>(smem + L::kCB);
  float* sP = reinterpret_cast<float*>(smem + L::kPM);
  float* sM = sP + kT * kTS;
  float* sR = sP;                    // G, then H (after the pairs)
  float* sRow = reinterpret_cast<float*>(smem + L::kSums);
  float* sCol = sRow + 2 * kT;
  float* sK = sCol + 4 * kT;
  float* sI = sK + 2 * kT;
  float* sGH = sI + 2 * kT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;   // row strip, column half
  const int ra = 16 * wr + g;                // a warp's rows ra, ra + 8
  const int bh = blockIdx.x, c = blockIdx.y;
  const int t0 = c * chunk;
  const int n = min(chunk, S - t0);
  const int nt = (n + kT - 1) / kT;
  const int bc = bh / group;
  const size_t row0 = static_cast<size_t>(bh) * S + t0;  // step t0 of bh
  const float* xb = xbar + row0 * hd;
  const float* dyb = dy + row0 * hd;
  const Tin* Bb = Bm + (static_cast<size_t>(bc) * S + t0) * DS;
  const Tin* Cb = Cm + (static_cast<size_t>(bc) * S + t0) * DS;
  const float* cb = cum + row0;
  const size_t st = (static_cast<size_t>(bh) * nc + c) * hd * DS;
  const float* H = hs + st;
  const float* G = gs + st;
  const float* CBc = cbs + (static_cast<size_t>(bc) * nc + c) * ntt * kT * kT;
  const float tot = cb[n - 1];

  auto load_cb = [&](int ti, int tj) {
    const float* src = CBc + static_cast<size_t>(ti * (ti + 1) / 2 + tj) * kT * kT;
    for (int e = tid; e < kT * kT / 4; e += kThreads) {
      const int r = e / (kT / 4), cc = 4 * (e % (kT / 4));
      cp_async16(smem_addr(sCB + r * kTS + cc), src + r * kT + cc, true);
    }
  };
  auto load_state = [&](const float* src) {
    for (int e = tid; e < HP * DS / 4; e += kThreads) {
      const int p = e / (DS / 4), s = 4 * (e % (DS / 4));
      const bool ok = p < hd;
      cp_async16(smem_addr(sR + p * GS + s),
                 ok ? src + static_cast<size_t>(p) * DS + s : src, ok);
    }
  };

  // sum G o H for d tot, the warps' parts summed in order at the end
  {
    float gh = 0.f;
    for (int i = tid; i < hd * DS; i += kThreads) gh = fmaf(G[i], H[i], gh);
    gh = warp_sum(gh);
    if (lane == 0) sGH[warp] = gh;
  }

  float kacc = 0.f;                  // thread t < 64: K summed over the tiles
  for (int tj = 0; tj < nt; ++tj) {
    const int j0 = tj * kT;
    float adx[NP][4], adb[NS][4];    // dX_j, dB_j: rows ra, ra + 8
#pragma unroll
    for (int t = 0; t < NP; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) adx[t][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NS; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) adb[t][e] = 0.f;
    float colsum = 0.f;              // thread t < 64: column t's sum of R
    for (int ti = nt - 1; ti >= tj; --ti) {
      const int i0 = ti * kT;
      const bool first = tj == 0;    // the first pair of row tile ti
      if (ti == nt - 1) {            // a new column tile
        load_rows<HP, XS>(sX, xb, j0, n, hd);
        load_bc<Tin, DS, BS>(sB, Bb, j0, n);
        load_cum(scj, cb, j0, n);
        if (tj == 0) load_cb(ti, tj);  // later pairs' were prefetched
        load_rows<HP, XS>(sDY, dyb, i0, n, hd);
        load_bc<Tin, DS, BS>(sC, Cb, i0, n);
        load_cum(sci, cb, i0, n);
      }                              // later row tiles were prefetched
      cp_async_commit();
      // thread t < 64: row t's sum of R so far, read while the pair runs
      const bool own = tid < kT && i0 + tid < n;
      const float dprev = own && !first ? dcum[row0 + i0 + tid] : 0.f;
      cp_async_wait<0>();
      __syncthreads();

      // -- dP = dY_i X_j^T (rows ra, ra + 8; columns 32 wc + 8 t + 2q, + 1),
      // k slots q, q + 4 taking p = 8 ks + 2q, + 1; then P, M, R ------------
      {
        float dp[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[t][e] = 0.f;
#pragma unroll 4
        for (int ks = 0; ks < HP / 8; ++ks) {
          const int p = 8 * ks + 2 * q;
          const float2 a0 = ld2(sDY + ra * XS + p);
          const float2 a1 = ld2(sDY + (ra + 8) * XS + p);
          uint32_t ah[4], al[4];
          frag_a<false>(a0.x, a1.x, a0.y, a1.y, ah, al);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 b = ld2(sX + (32 * wc + 8 * t + g) * XS + p);
            uint32_t bh0, bl0, bh1, bl1;
            tf32_split(b.x, bh0, bl0);
            tf32_split(b.y, bh1, bl1);
            mma3<false, false>(dp[t], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        const int ia = i0 + ra, ib = ia + 8;
        const float ci0 = sci[ra], ci1 = sci[ra + 8];
        float rs0 = 0.f, rs1 = 0.f, cs[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int jl = 32 * wc + 8 * t + 2 * q;
          const int ja = j0 + jl;
          const float cj0 = scj[jl], cj1 = scj[jl + 1];
          const float2 cba = ld2(sCB + ra * kTS + jl);
          const float2 cbb = ld2(sCB + (ra + 8) * kTS + jl);
          // masked before the exponent: j <= i < n (the fast exp's error,
          // a few f32 ulps at these arguments, is far inside 2e-5)
          const float l0 = __expf(ja <= ia && ia < n ? ci0 - cj0 : -INFINITY);
          const float l1 =
              __expf(ja + 1 <= ia && ia < n ? ci0 - cj1 : -INFINITY);
          const float l2 = __expf(ja <= ib && ib < n ? ci1 - cj0 : -INFINITY);
          const float l3 =
              __expf(ja + 1 <= ib && ib < n ? ci1 - cj1 : -INFINITY);
          const float p0 = cba.x * l0, p1 = cba.y * l1, p2 = cbb.x * l2,
                      p3 = cbb.y * l3;
          const float r0 = dp[t][0] * p0, r1 = dp[t][1] * p1,
                      r2 = dp[t][2] * p2, r3 = dp[t][3] * p3;
          *reinterpret_cast<float2*>(sP + ra * kTS + jl) = make_float2(p0, p1);
          *reinterpret_cast<float2*>(sP + (ra + 8) * kTS + jl) =
              make_float2(p2, p3);
          *reinterpret_cast<float2*>(sM + ra * kTS + jl) =
              make_float2(dp[t][0] * l0, dp[t][1] * l1);
          *reinterpret_cast<float2*>(sM + (ra + 8) * kTS + jl) =
              make_float2(dp[t][2] * l2, dp[t][3] * l3);
          rs0 += r0 + r1;
          rs1 += r2 + r3;
          cs[t][0] = r0 + r2;
          cs[t][1] = r1 + r3;
        }
        // R's row sums over the warp's 32 columns (the 4 lanes of a row),
        // column sums over its 16 rows (the 8 lanes of a column)
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
        if (q == 0) {
          sRow[wc * kT + ra] = rs0;
          sRow[wc * kT + ra + 8] = rs1;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = cs[t][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) sCol[wr * kT + 32 * wc + 8 * t + 2 * q + e] = v;
          }
      }
      __syncthreads();

      // the next pair's C B^T, while this pair's products run
      if (ti > tj) {
        load_cb(ti - 1, tj);
      } else if (tj + 1 < nt) {
        load_cb(nt - 1, tj + 1);
      }
      cp_async_commit();
      if (tid < kT) {
        colsum += (sCol[tid] + sCol[kT + tid]) +
                  (sCol[2 * kT + tid] + sCol[3 * kT + tid]);
        if (own) dcum[row0 + i0 + tid] = dprev + (sRow[tid] + sRow[kT + tid]);
      }

      // -- dX_j += P^T dY_i, dB_j += M^T C_i (rows ra, ra + 8 of the column
      // tile; k slots q, q + 4 taking i = 8 ks + q, + 4) --------------------------
#pragma unroll 2
      for (int ks = 0; ks < kT / 8; ++ks) {
        const int i = 8 * ks + q;
        uint32_t ph[4], pl[4], mh[4], ml[4];
        frag_a<false>(sP[i * kTS + ra], sP[i * kTS + ra + 8],
                      sP[(i + 4) * kTS + ra], sP[(i + 4) * kTS + ra + 8], ph,
                      pl);
        frag_a<false>(sM[i * kTS + ra], sM[i * kTS + ra + 8],
                      sM[(i + 4) * kTS + ra], sM[(i + 4) * kTS + ra + 8], mh,
                      ml);
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const int p = (HP / 2) * wc + 8 * t + g;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(sDY[i * XS + p], bh0, bl0);
          tf32_split(sDY[(i + 4) * XS + p], bh1, bl1);
          mma3<false, false>(adx[t], ph, pl, bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          const int s = (DS / 2) * wc + 8 * t + g;
          uint32_t bh0, bl0, bh1, bl1;
          split<kEx>(ld1(sC + i * BS + s), bh0, bl0);
          split<kEx>(ld1(sC + (i + 4) * BS + s), bh1, bl1);
          mma3<false, kEx>(adb[t], mh, ml, bh0, bh1, bl0, bl1);
        }
      }
      __syncthreads();               // dY_i, C_i are read
      if (ti > tj) {                 // the next pair's row tile, meanwhile
        load_rows<HP, XS>(sDY, dyb, i0 - kT, n, hd);
        load_bc<Tin, DS, BS>(sC, Cb, i0 - kT, n);
        load_cum(sci, cb, i0 - kT, n);
      }
      cp_async_commit();
      // -- dC_i += M B_j (rows ra, ra + 8 of the row tile; k slots q, q + 4
      // taking j = 8 ks + 2q, + 1), into this head's partial ---------------------
      {
        // this head's partial so far, read while the product runs
        float acc[NS][4];
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          const int s = (DS / 2) * wc + 8 * t + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 old = make_float2(0.f, 0.f);
            if (!first && i0 + ra + 8 * h < n)
              old = *reinterpret_cast<const float2*>(
                  dCp + (row0 + i0 + ra + 8 * h) * DS + s);
            acc[t][2 * h] = old.x;
            acc[t][2 * h + 1] = old.y;
          }
        }
#pragma unroll 2
        for (int ks = 0; ks < kT / 8; ++ks) {
          const int j = 8 * ks + 2 * q;
          const float2 m0 = ld2(sM + ra * kTS + j);
          const float2 m1 = ld2(sM + (ra + 8) * kTS + j);
          uint32_t mh[4], ml[4];
          frag_a<false>(m0.x, m1.x, m0.y, m1.y, mh, ml);
#pragma unroll
          for (int t = 0; t < NS; ++t) {
            const int s = (DS / 2) * wc + 8 * t + g;
            uint32_t bh0, bl0, bh1, bl1;
            split<kEx>(ld1(sB + j * BS + s), bh0, bl0);
            split<kEx>(ld1(sB + (j + 1) * BS + s), bh1, bl1);
            mma3<false, kEx>(acc[t], mh, ml, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          const int s = (DS / 2) * wc + 8 * t + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (i0 + ra + 8 * h >= n) continue;
            *reinterpret_cast<float2*>(dCp + (row0 + i0 + ra + 8 * h) * DS +
                                       s) =
                make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
          }
        }
      }
      __syncthreads();               // P, M and B_j are read
    }

    // -- tile j is complete but for the state terms; the stage holds row
    // tile j (the last pair was (j, j)) -------------------------------------------
    load_state(G);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float ea = j0 + ra < n ? expf(tot - scj[ra]) : 0.f;
    const float eb = j0 + ra + 8 < n ? expf(tot - scj[ra + 8]) : 0.f;
    {
      // dX_j += diag(e) B_j G^T: k slots q, q + 4 taking s = 8 ks + 2q, + 1
      float acc[NP][4];
#pragma unroll
      for (int t = 0; t < NP; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < DS / 8; ++ks) {
        const int s = 8 * ks + 2 * q;
        const float2 b0 = ld2(sB + ra * BS + s);
        const float2 b1 = ld2(sB + (ra + 8) * BS + s);
        uint32_t ah[4], al[4];
        frag_a<kEx>(b0.x, b1.x, b0.y, b1.y, ah, al);
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const float2 gv = ld2(sR + ((HP / 2) * wc + 8 * t + g) * GS + s);
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(gv.x, bh0, bl0);
          tf32_split(gv.y, bh1, bl1);
          mma3<kEx, false>(acc[t], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        adx[t][0] = fmaf(ea, acc[t][0], adx[t][0]);
        adx[t][1] = fmaf(ea, acc[t][1], adx[t][1]);
        adx[t][2] = fmaf(eb, acc[t][2], adx[t][2]);
        adx[t][3] = fmaf(eb, acc[t][3], adx[t][3]);
      }
    }
    {
      // V_j = diag(e) X_j G: k slots q, q + 4 taking p = 8 ks + 2q, + 1
      float acc[NS][4];
#pragma unroll
      for (int t = 0; t < NS; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < HP / 8; ++ks) {
        const int p = 8 * ks + 2 * q;
        const float2 x0 = ld2(sX + ra * XS + p);
        const float2 x1 = ld2(sX + (ra + 8) * XS + p);
        uint32_t ah[4], al[4];
        frag_a<false>(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          const int s = (DS / 2) * wc + 8 * t + g;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(sR[p * GS + s], bh0, bl0);
          tf32_split(sR[(p + 1) * GS + s], bh1, bl1);
          mma3<false, false>(acc[t], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      float k0 = 0.f, k1 = 0.f;      // B_j . V_j over the warp's columns
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int s = (DS / 2) * wc + 8 * t + 2 * q;
        const float v0 = ea * acc[t][0], v1 = ea * acc[t][1];
        const float v2 = eb * acc[t][2], v3 = eb * acc[t][3];
        adb[t][0] += v0;
        adb[t][1] += v1;
        adb[t][2] += v2;
        adb[t][3] += v3;
        const float2 b0 = ld2(sB + ra * BS + s);
        const float2 b1 = ld2(sB + (ra + 8) * BS + s);
        k0 = fmaf(b0.x, v0, fmaf(b0.y, v1, k0));
        k1 = fmaf(b1.x, v2, fmaf(b1.y, v3, k1));
      }
      k0 += __shfl_xor_sync(0xffffffffu, k0, 1);
      k0 += __shfl_xor_sync(0xffffffffu, k0, 2);
      k1 += __shfl_xor_sync(0xffffffffu, k1, 1);
      k1 += __shfl_xor_sync(0xffffffffu, k1, 2);
      if (q == 0) {
        sK[wc * kT + ra] = k0;
        sK[wc * kT + ra + 8] = k1;
      }
    }
    // dX_j and dB_j are complete
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j0 + ra + 8 * h >= n) continue;
      const size_t o = row0 + j0 + ra + 8 * h;
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const int p = (HP / 2) * wc + 8 * t + 2 * q;
        if (p < hd)
          *reinterpret_cast<float2*>(dx + o * hd + p) =
              make_float2(adx[t][2 * h], adx[t][2 * h + 1]);
      }
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int s = (DS / 2) * wc + 8 * t + 2 * q;
        *reinterpret_cast<float2*>(dBp + o * DS + s) =
            make_float2(adb[t][2 * h], adb[t][2 * h + 1]);
      }
    }
    __syncthreads();                 // G is read
    load_state(H);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    {
      // W_j = diag(exp(cum)) dY_j H; dC_j += W_j; C_j . W_j
      const float fa = j0 + ra < n ? expf(sci[ra]) : 0.f;
      const float fb = j0 + ra + 8 < n ? expf(sci[ra + 8]) : 0.f;
      float acc[NS][4];
#pragma unroll
      for (int t = 0; t < NS; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < HP / 8; ++ks) {
        const int p = 8 * ks + 2 * q;
        const float2 d0 = ld2(sDY + ra * XS + p);
        const float2 d1 = ld2(sDY + (ra + 8) * XS + p);
        uint32_t ah[4], al[4];
        frag_a<false>(d0.x, d1.x, d0.y, d1.y, ah, al);
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          const int s = (DS / 2) * wc + 8 * t + g;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(sR[p * GS + s], bh0, bl0);
          tf32_split(sR[(p + 1) * GS + s], bh1, bl1);
          mma3<false, false>(acc[t], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int s = (DS / 2) * wc + 8 * t + 2 * q;
        const float w0 = fa * acc[t][0], w1 = fa * acc[t][1];
        const float w2 = fb * acc[t][2], w3 = fb * acc[t][3];
        const float2 ca = ld2(sC + ra * BS + s);
        const float2 cc = ld2(sC + (ra + 8) * BS + s);
        c0 = fmaf(ca.x, w0, fmaf(ca.y, w1, c0));
        c1 = fmaf(cc.x, w2, fmaf(cc.y, w3, c1));
        if (j0 + ra < n) {
          float2* o = reinterpret_cast<float2*>(dCp + (row0 + j0 + ra) * DS + s);
          const float2 old = *o;
          *o = make_float2(old.x + w0, old.y + w1);
        }
        if (j0 + ra + 8 < n) {
          float2* o =
              reinterpret_cast<float2*>(dCp + (row0 + j0 + ra + 8) * DS + s);
          const float2 old = *o;
          *o = make_float2(old.x + w2, old.y + w3);
        }
      }
      c0 += __shfl_xor_sync(0xffffffffu, c0, 1);
      c0 += __shfl_xor_sync(0xffffffffu, c0, 2);
      c1 += __shfl_xor_sync(0xffffffffu, c1, 1);
      c1 += __shfl_xor_sync(0xffffffffu, c1, 2);
      if (q == 0) {
        sI[wc * kT + ra] = c0;
        sI[wc * kT + ra + 8] = c1;
      }
    }
    __syncthreads();
    if (tid < kT) {
      // the row sums (accumulated in dcum), the column sums, -B . V, C . W
      const float kk = sK[tid] + sK[kT + tid];
      if (j0 + tid < n) {
        float& d = dcum[row0 + j0 + tid];
        d = d - colsum - kk + (sI[tid] + sI[kT + tid]);
      }
      kacc += kk;
    }
    __syncthreads();                 // before the next column tile's loads
  }

  // d tot, to the chunk's last step: sum_j K_j + exp(tot) sum G o H, added
  // by the thread that wrote that step
  if (tid < kT) sK[tid] = kacc;
  __syncthreads();
  if (tid == (n - 1) % kT) {
    float ks = 0.f;
    for (int t = 0; t < kT; ++t) ks += sK[t];
    float gh = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) gh += sGH[w];
    dcum[row0 + n - 1] += fmaf(expf(tot), gh, ks);
  }
}

// tiles of C B^T on and below the diagonal of the longest chunk
inline int cb_tiles(int S, int chunk) {
  const int nt = ((chunk < S ? chunk : S) + kT - 1) / kT;
  return nt * (nt + 1) / 2;
}

template <typename Tin, int HP, int DS>
int launch(const float* xbar, const void* B, const void* C, const float* cum,
           const float* dy, const float* dh, float* dxbar, void* dB, void* dC,
           float* dcum, float* states, float* partial, int bh, int bh_bc,
           int S, int hd, int chunk, cudaStream_t stream) {
  using L = ChunkLayout<Tin, HP, DS>;
  using PL = PrepLayout<Tin, HP, DS>;
  static_assert(L::kBytes <= 232448 && PL::kBytes <= 232448, "shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_bwd_chunk_kernel<Tin, HP, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const cudaError_t pattr = cudaFuncSetAttribute(
      ssm_bwd_prep_kernel<Tin, HP, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kBytes);
  if (pattr != cudaSuccess) return static_cast<int>(pattr);
  const int group = bh / bh_bc;
  const int nc = (S + chunk - 1) / chunk;
  const int ntt = cb_tiles(S, chunk);
  const Tin* Bt = static_cast<const Tin*>(B);
  const Tin* Ct = static_cast<const Tin*>(C);
  const int E = hd * DS;
  float* hs = states;
  float* gs = states + static_cast<size_t>(bh) * nc * E;
  float* cbs = gs + static_cast<size_t>(bh) * nc * E;
  float* dBp = partial;
  float* dCp = partial + static_cast<size_t>(bh) * S * DS;
  ssm_bwd_prep_kernel<Tin, HP, DS>
      <<<dim3(bh + bh_bc, nc), kThreads, PL::kBytes, stream>>>(
          xbar, Bt, Ct, cum, dy, hs, gs, cbs, bh, S, hd, group, chunk, nc,
          ntt);
  ssm_bwd_carry_kernel<<<dim3(bh, (E + kThreads - 1) / kThreads, 2), kThreads,
                         0, stream>>>(hs, gs, cum, dh, S, E, chunk, nc);
  ssm_bwd_chunk_kernel<Tin, HP, DS><<<dim3(bh, nc), kThreads, L::kBytes,
                                      stream>>>(
      xbar, Bt, Ct, cum, dy, hs, gs, cbs, dxbar, dBp, dCp, dcum, S, hd, group,
      chunk, nc, ntt);
  const long long SE = static_cast<long long>(S) * DS;
  sum_partials<Tin>(dBp, static_cast<Tin*>(dB), bh_bc, SE, group, group * SE,
                    SE, stream);
  sum_partials<Tin>(dCp, static_cast<Tin*>(dC), bh_bc, SE, group, group * SE,
                    SE, stream);
  return 0;
}

template <typename Tin, int HP>
int launch_ds(int ds, const float* xbar, const void* B, const void* C,
              const float* cum, const float* dy, const float* dh,
              float* dxbar, void* dB, void* dC, float* dcum, float* states,
              float* partial, int bh, int bh_bc, int S, int hd, int chunk,
              cudaStream_t stream) {
#define REPRO_SSM_BWD_DS(DS)                                                  \
  case DS:                                                                    \
    return launch<Tin, HP, DS>(xbar, B, C, cum, dy, dh, dxbar, dB, dC, dcum,  \
                               states, partial, bh, bh_bc, S, hd, chunk,      \
                               stream);
  switch (ds) {
    REPRO_SSM_BWD_DS(16)
    REPRO_SSM_BWD_DS(32)
    REPRO_SSM_BWD_DS(64)
    REPRO_SSM_BWD_DS(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSM_BWD_DS
}

template <typename Tin>
int launch_hd(int ds, const float* xbar, const void* B, const void* C,
              const float* cum, const float* dy, const float* dh,
              float* dxbar, void* dB, void* dC, float* dcum, float* states,
              float* partial, int bh, int bh_bc, int S, int hd, int chunk,
              cudaStream_t stream) {
  if (hd <= 64)
    return launch_ds<Tin, 64>(ds, xbar, B, C, cum, dy, dh, dxbar, dB, dC,
                              dcum, states, partial, bh, bh_bc, S, hd, chunk,
                              stream);
  if (hd <= 128)
    return launch_ds<Tin, 128>(ds, xbar, B, C, cum, dy, dh, dxbar, dB, dC,
                               dcum, states, partial, bh, bh_bc, S, hd, chunk,
                               stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

extern "C" int repro_ssm_scan_bwd(const void* xbar, const void* B,
                                  const void* C, const void* cumlog,
                                  const void* dy, const void* dh, void* dxbar,
                                  void* dB, void* dC, void* dcumlog,
                                  void* states, void* partial, int bh,
                                  int bh_bc, int S, int hd, int ds, int chunk,
                                  int dtype, void* stream) {
  if (bh_bc <= 0 || bh % bh_bc != 0 || chunk <= 0 || S <= 0 || hd <= 0 ||
      hd % 4 != 0 || (S + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* aligned[] = {xbar, B, C, dy, dxbar, states, partial};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const float* xb = static_cast<const float*>(xbar);
  const float* cl = static_cast<const float*>(cumlog);
  const float* dyp = static_cast<const float*>(dy);
  const float* dhp = static_cast<const float*>(dh);
  float* dxp = static_cast<float*>(dxbar);
  float* dcp = static_cast<float*>(dcumlog);
  float* stp = static_cast<float*>(states);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch_hd<__nv_bfloat16>(ds, xb, B, C, cl, dyp, dhp, dxp, dB,
                                         dC, dcp, stp, pp, bh, bh_bc, S, hd,
                                         chunk, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch_hd<float>(ds, xb, B, C, cl, dyp, dhp, dxp, dB, dC, dcp,
                                 stp, pp, bh, bh_bc, S, hd, chunk, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
