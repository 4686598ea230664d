// ssm_scan_bwd: the gradient of ssm_scan (csrc/ssm_scan.cu), the Mamba2
// (SSD) selective scan. Inputs: the forward's xbar (BH, S, hd) f32, B, C
// (BH_bc, S, ds) bf16 or f32 (row bh reads B/C row bh / (BH / BH_bc)),
// cumlog (BH, S) f32 reset every `chunk` steps; the gradients dy (BH, S,
// hd) f32 of y and dh (BH, hd, ds) f32 of the final state (zeros when
// the caller drops the state, as training does; carried in as the
// initial reverse state). Writes dxbar (BH, S, hd) f32, dB and dC
// (BH_bc, S, ds) in B's dtype (summed over the heads of a group) and
// dcumlog (BH, S) f32.
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
// Kernels (f32 on the CUDA cores throughout; a first, simple design):
// - ssm_bwd_state_kernel: grid (BH, hd / 16, 2). z = 0 steps the state
//   forward over the chunks and writes H_c at each chunk's start; z = 1
//   carries G back from dh over the chunks in reverse and writes G_c. A
//   block owns 16 rows of the (hd, ds) matrix (the rows are independent),
//   16 threads a row holding ds / 16 entries each; inputs of 32 steps are
//   staged in shared memory. 2 BH S hd ds f32 flops each way.
// - ssm_bwd_chunk_kernel: grid (BH, nc), a block a (head, chunk), 256
//   threads. The chunk runs in tiles of 64 steps: a first sweep over the
//   column tiles j (each against the row tiles i >= j) forms dX, dB and
//   the column sums of R; a second over the row tiles i (each against
//   the tiles j <= i) forms dC and the row sums, and assembles dcum. Each
//   tile pair forms C B^T and dY X^T as 64 x 64 products (a thread a 4 x 4
//   block: rows ty + 16a, columns tx + 16b), then P, M and R in shared
//   memory, and the 64-row products of P^T, M^T and M with the staged
//   tiles. The state terms read G and H in panels of 32 rows. dB and dC
//   are written as a partial a head (f32).
// - sum_partials_kernel (common.cuh): dB and dC, the partials summed over
//   the heads of a group in order, cast to B's dtype. No float atomics
//   anywhere: two calls give the same bits.
// Bound on an H100: operations. At zamba2-1.2b's training microbatch (BH
// 128 = 2 x 64 heads, S 4096, hd = ds = 64, chunk 256) the chunk pass
// does 5 64-wide products a live (i, j) pair of a chunk (C B^T, dY X^T,
// P^T dY, M^T C, M B) and 3 state products a step; the sweeps form C B^T
// and dY X^T twice (7 products a tile pair as run); chip_smoke.py counts
// the flops (ssm_bwd_flops: 56 GFLOP, 0.84 ms at 67 TFLOP/s; 0.41 GB of
// bytes, 0.12 ms). Measured there on an H100 (700 W): 7.45 ms, 0.11 of
// the bound; the chunk pass is 0.8 of it, the serial state pass 0.2. hd
// is at most 128 (panels of 64).
// tests/test_torch_scan_grad.py emulates this on the CPU.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;

// -- the state pass: H_c forward, G_c in reverse ---------------------------------

constexpr int kSRows = 16;         // rows of the state a block
constexpr int kSTPR = 16;          // threads a row
constexpr int kST = 32;            // steps a staged tile
static_assert(kSRows * kSTPR == kThreads, "a thread a slice of a row");

template <typename Tin, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_bwd_state_kernel(const float* __restrict__ xbar,
                     const Tin* __restrict__ Bm, const Tin* __restrict__ Cm,
                     const float* __restrict__ cum,
                     const float* __restrict__ dy,
                     const float* __restrict__ dh, float* __restrict__ hs,
                     float* __restrict__ gs, int S, int hd, int group,
                     int chunk, int nc) {
  constexpr int kNS = DS / kSTPR;  // entries a thread
  __shared__ float su[kST][kSRows];
  __shared__ float sv[kST][DS];
  __shared__ float sw[kST];
  const bool rev = blockIdx.z == 1;
  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kSRows;
  const int r = threadIdx.x / kSTPR, q = threadIdx.x % kSTPR;
  const int p = p0 + r;
  const int bc = bh / group;
  // forward: u = xbar, v = B, weight exp(tot - cum_j); reverse: u = dy,
  // v = C, weight exp(cum_i)
  const float* U = (rev ? dy : xbar) + static_cast<size_t>(bh) * S * hd;
  const Tin* V = (rev ? Cm : Bm) + static_cast<size_t>(bc) * S * DS;
  const float* cb = cum + static_cast<size_t>(bh) * S;
  float* out = (rev ? gs : hs) + static_cast<size_t>(bh) * nc * hd * DS;

  float x[kNS];
#pragma unroll
  for (int m = 0; m < kNS; ++m)
    x[m] = (rev && p < hd)
               ? dh[(static_cast<size_t>(bh) * hd + p) * DS + q + kSTPR * m]
               : 0.f;
  for (int it = 0; it < nc; ++it) {
    const int c = rev ? nc - 1 - it : it;
    const int t0 = c * chunk;
    const int n = min(chunk, S - t0);
    const float tot = cb[t0 + n - 1];
    if (p < hd) {
#pragma unroll
      for (int m = 0; m < kNS; ++m)
        out[(static_cast<size_t>(c) * hd + p) * DS + q + kSTPR * m] = x[m];
    }
    float acc[kNS];
#pragma unroll
    for (int m = 0; m < kNS; ++m) acc[m] = 0.f;
    for (int s0 = 0; s0 < n; s0 += kST) {
      const int nt = min(kST, n - s0);
      __syncthreads();             // the previous tile has been read
      for (int i = threadIdx.x; i < kST * DS; i += kThreads) {
        const int t = i / DS, s = i % DS;
        sv[t][s] = t < nt ? to_f32(V[static_cast<size_t>(t0 + s0 + t) * DS + s])
                          : 0.f;
      }
      for (int i = threadIdx.x; i < kST * kSRows; i += kThreads) {
        const int t = i / kSRows, cc = i % kSRows;
        su[t][cc] = (t < nt && p0 + cc < hd)
                        ? U[static_cast<size_t>(t0 + s0 + t) * hd + p0 + cc]
                        : 0.f;
      }
      if (threadIdx.x < kST) {
        float wt = 0.f;
        if (static_cast<int>(threadIdx.x) < nt) {
          const float ct = cb[t0 + s0 + threadIdx.x];
          wt = rev ? expf(ct) : expf(tot - ct);
        }
        sw[threadIdx.x] = wt;
      }
      __syncthreads();
      for (int t = 0; t < nt; ++t) {
        const float a = sw[t] * su[t][r];
#pragma unroll
        for (int m = 0; m < kNS; ++m) acc[m] = fmaf(a, sv[t][q + kSTPR * m], acc[m]);
      }
    }
    const float g = expf(tot);
#pragma unroll
    for (int m = 0; m < kNS; ++m) x[m] = fmaf(g, x[m], acc[m]);
  }
}

// -- the chunk pass: dX, dB, dC and dcum of a (head, chunk) ---------------------

constexpr int kT = 64;             // steps a tile
constexpr int kGP = 32;            // rows of G or H a staged panel

// Shared memory, in floats: the column tile's X, B, cum; the row tile's
// dY, C, cum; P, M and R of the tile pair; a panel of G or H; K_j, then
// C_i . W_i, a row of the tile; the block's sums. Rows padded to an odd
// stride, so a column read across 16 threads hits 16 banks.
template <int HP, int DS>
struct ChunkLayout {
  static constexpr int kXS = HP + 1, kBS = DS + 1, kPS = kT + 1;
  static constexpr int kX = 0, kDY = kX + kT * kXS, kB = kDY + kT * kXS,
                       kC = kB + kT * kBS, kP = kC + kT * kBS,
                       kM = kP + kT * kPS, kR = kM + kT * kPS,
                       kG = kR + kT * kPS, kCJ = kG + kGP * kBS,
                       kCI = kCJ + kT, kK = kCI + kT, kSum = kK + kT,
                       kFloats = kSum + 1 + kThreads / 32;
  static constexpr int kBytes = kFloats * 4;
};

template <typename Tin, int HP, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssm_bwd_chunk_kernel(const float* __restrict__ xbar,
                     const Tin* __restrict__ Bm, const Tin* __restrict__ Cm,
                     const float* __restrict__ cum,
                     const float* __restrict__ dy,
                     const float* __restrict__ hs,
                     const float* __restrict__ gs, float* __restrict__ dx,
                     float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dcum, int S, int hd, int group,
                     int chunk, int nc) {
  using L = ChunkLayout<HP, DS>;
  constexpr int XS = L::kXS, BS = L::kBS, PS = L::kPS;
  constexpr int NP = HP / 16, NS = DS / 16;  // columns a thread: of hd, ds
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + L::kX;
  float* sdy = smem + L::kDY;
  float* sB = smem + L::kB;
  float* sC = smem + L::kC;
  float* sP = smem + L::kP;
  float* sM = smem + L::kM;
  float* sR = smem + L::kR;
  float* sG = smem + L::kG;
  float* scj = smem + L::kCJ;
  float* sci = smem + L::kCI;
  float* sK = smem + L::kK;
  float* sSum = smem + L::kSum;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
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
  const float tot = cb[n - 1];

  // Staging, zero past the chunk's n steps and past hd.
  auto load_rows = [&](float* dst, const float* src, int s0) {
    for (int e = tid; e < kT * HP; e += kThreads) {
      const int t = e / HP, p = e % HP;
      dst[t * XS + p] = (s0 + t < n && p < hd)
                            ? src[static_cast<size_t>(s0 + t) * hd + p]
                            : 0.f;
    }
  };
  auto load_bc = [&](float* dst, const Tin* src, int s0) {
    for (int e = tid; e < kT * DS; e += kThreads) {
      const int t = e / DS, s = e % DS;
      dst[t * BS + s] =
          s0 + t < n ? to_f32(src[static_cast<size_t>(s0 + t) * DS + s]) : 0.f;
    }
  };
  auto load_cum = [&](float* dst, int s0) {
    if (tid < kT) dst[tid] = s0 + tid < n ? cb[s0 + tid] : 0.f;
  };
  auto load_panel = [&](const float* src, int p0) {
    for (int e = tid; e < kGP * DS; e += kThreads) {
      const int pp = e / DS, s = e % DS;
      sG[pp * BS + s] =
          p0 + pp < hd ? src[static_cast<size_t>(p0 + pp) * DS + s] : 0.f;
    }
  };

  // P, M and R of the row tile at i0 (sdy, sC, sci) against the column
  // tile at j0 (sx, sB, scj), masked (j <= i < n) before the exponent.
  auto pair = [&](int i0, int j0) {
    float cbv[4][4], dpv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cbv[a][b] = dpv[a][b] = 0.f;
#pragma unroll 4
    for (int s = 0; s < DS; ++s) {
      float ca[4], bb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ca[a] = sC[(ty + 16 * a) * BS + s];
#pragma unroll
      for (int b = 0; b < 4; ++b) bb[b] = sB[(tx + 16 * b) * BS + s];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) cbv[a][b] = fmaf(ca[a], bb[b], cbv[a][b]);
    }
#pragma unroll 4
    for (int p = 0; p < HP; ++p) {
      float da[4], xa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sdy[(ty + 16 * a) * XS + p];
#pragma unroll
      for (int b = 0; b < 4; ++b) xa[b] = sx[(tx + 16 * b) * XS + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dpv[a][b] = fmaf(da[a], xa[b], dpv[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = ty + 16 * a, j = tx + 16 * b;
        const bool live = j0 + j <= i0 + i && i0 + i < n;
        const float l = expf(live ? sci[i] - scj[j] : -INFINITY);
        const float pv = cbv[a][b] * l;
        sP[i * PS + j] = pv;
        sM[i * PS + j] = dpv[a][b] * l;
        sR[i * PS + j] = dpv[a][b] * pv;
      }
  };

  // -- sweep A: the column tiles j: dX, dB and the column sums of R -------------
  float ksum = 0.f;                  // thread 0: sum_j B_j . V_j, in order
  for (int tj = 0; tj < nt; ++tj) {
    const int j0 = tj * kT;
    __syncthreads();
    load_rows(sx, xb, j0);
    load_bc(sB, Bb, j0);
    load_cum(scj, j0);
    float adx[4][NP], adb[4][NS];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < NP; ++b) adx[a][b] = 0.f;
#pragma unroll
      for (int b = 0; b < NS; ++b) adb[a][b] = 0.f;
    }
    float cs = 0.f;                  // thread j < 64: column j's sum of R
    for (int ti = tj; ti < nt; ++ti) {
      const int i0 = ti * kT;
      __syncthreads();
      load_rows(sdy, dyb, i0);
      load_bc(sC, Cb, i0);
      load_cum(sci, i0);
      __syncthreads();
      pair(i0, j0);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kT; ++i) {   // dX_j += P^T dY_i, dB_j += M^T C_i
        float pa[4], ma[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sP[i * PS + ty + 16 * a];
          ma[a] = sM[i * PS + ty + 16 * a];
        }
#pragma unroll
        for (int b = 0; b < NP; ++b) {
          const float d = sdy[i * XS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a) adx[a][b] = fmaf(pa[a], d, adx[a][b]);
        }
#pragma unroll
        for (int b = 0; b < NS; ++b) {
          const float cc = sC[i * BS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a) adb[a][b] = fmaf(ma[a], cc, adb[a][b]);
        }
      }
      if (tid < kT)
        for (int i = 0; i < kT; ++i) cs += sR[i * PS + tid];
    }
    // the state terms, G in panels: dX_j += e_j G B_j, V_j = e_j X_j G
    float e[4], vacc[4][NS];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      e[a] = expf(tot - scj[ty + 16 * a]);
#pragma unroll
      for (int b = 0; b < NS; ++b) vacc[a][b] = 0.f;
    }
#pragma unroll
    for (int p0 = 0; p0 < HP; p0 += kGP) {
      __syncthreads();
      load_panel(G, p0);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kGP / 16; ++b) {
          float g = 0.f;
#pragma unroll 8
          for (int s = 0; s < DS; ++s)
            g = fmaf(sB[(ty + 16 * a) * BS + s], sG[(tx + 16 * b) * BS + s], g);
          adx[a][p0 / 16 + b] = fmaf(e[a], g, adx[a][p0 / 16 + b]);
        }
#pragma unroll 4
      for (int pp = 0; pp < kGP; ++pp) {
        float xa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = sx[(ty + 16 * a) * XS + p0 + pp];
#pragma unroll
        for (int b = 0; b < NS; ++b) {
          const float g = sG[pp * BS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a) vacc[a][b] = fmaf(xa[a], g, vacc[a][b]);
        }
      }
    }
    float kj[4];                     // K_j = B_j . V_j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      kj[a] = 0.f;
#pragma unroll
      for (int b = 0; b < NS; ++b) {
        const float v = e[a] * vacc[a][b];
        adb[a][b] += v;
        kj[a] = fmaf(sB[(ty + 16 * a) * BS + tx + 16 * b], v, kj[a]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // over the half-warp's tx
        kj[a] += __shfl_xor_sync(0xffffffffu, kj[a], off);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = ty + 16 * a;
      if (j0 + j < n) {
        const size_t o = row0 + j0 + j;
#pragma unroll
        for (int b = 0; b < NP; ++b)
          if (tx + 16 * b < hd) dx[o * hd + tx + 16 * b] = adx[a][b];
#pragma unroll
        for (int b = 0; b < NS; ++b) dBp[o * DS + tx + 16 * b] = adb[a][b];
      }
      if (tx == 0) sK[j] = kj[a];
    }
    __syncthreads();
    if (tid < kT && j0 + tid < n) dcum[row0 + j0 + tid] = -cs - sK[tid];
    if (tid == 0)
      for (int j = 0; j < kT; ++j) ksum += sK[j];
  }

  // d tot: sum_j K_j + exp(tot) sum G o H, to the chunk's last step
  float gh = 0.f;
  for (int i = tid; i < hd * DS; i += kThreads) gh = fmaf(G[i], H[i], gh);
  gh = warp_sum(gh);
  __syncthreads();
  if (lane == 0) sSum[1 + warp] = gh;
  if (tid == 0) sSum[0] = ksum;
  __syncthreads();
  float ghs = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) ghs += sSum[1 + w];
  const float dtot = fmaf(expf(tot), ghs, sSum[0]);

  // -- sweep B: the row tiles i: dC, the row sums of R, dcum --------------------
  for (int ti = 0; ti < nt; ++ti) {
    const int i0 = ti * kT;
    __syncthreads();
    load_rows(sdy, dyb, i0);
    load_bc(sC, Cb, i0);
    load_cum(sci, i0);
    float adc[4][NS];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NS; ++b) adc[a][b] = 0.f;
    float rs = 0.f;                  // thread i < 64: row i's sum of R
    for (int tj = 0; tj <= ti; ++tj) {
      const int j0 = tj * kT;
      __syncthreads();
      load_rows(sx, xb, j0);
      load_bc(sB, Bb, j0);
      load_cum(scj, j0);
      __syncthreads();
      pair(i0, j0);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < kT; ++j) {   // dC_i += M B_j
        float ma[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ma[a] = sM[(ty + 16 * a) * PS + j];
#pragma unroll
        for (int b = 0; b < NS; ++b) {
          const float bb = sB[j * BS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a) adc[a][b] = fmaf(ma[a], bb, adc[a][b]);
        }
      }
      if (tid < kT)
        for (int j = 0; j < kT; ++j) rs += sR[tid * PS + j];
    }
    // the state term, H in panels: W_i = exp(cum_i) dY_i H
    float wacc[4][NS];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NS; ++b) wacc[a][b] = 0.f;
#pragma unroll
    for (int p0 = 0; p0 < HP; p0 += kGP) {
      __syncthreads();
      load_panel(H, p0);
      __syncthreads();
#pragma unroll 4
      for (int pp = 0; pp < kGP; ++pp) {
        float da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) da[a] = sdy[(ty + 16 * a) * XS + p0 + pp];
#pragma unroll
        for (int b = 0; b < NS; ++b) {
          const float h = sG[pp * BS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a) wacc[a][b] = fmaf(da[a], h, wacc[a][b]);
        }
      }
    }
    float inter[4];                  // C_i . W_i
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const float ei = expf(sci[i]);
      inter[a] = 0.f;
#pragma unroll
      for (int b = 0; b < NS; ++b) {
        const float w = ei * wacc[a][b];
        adc[a][b] += w;
        inter[a] = fmaf(sC[i * BS + tx + 16 * b], w, inter[a]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        inter[a] += __shfl_xor_sync(0xffffffffu, inter[a], off);
      if (i0 + i < n) {
        const size_t o = row0 + i0 + i;
#pragma unroll
        for (int b = 0; b < NS; ++b) dCp[o * DS + tx + 16 * b] = adc[a][b];
      }
    }
    __syncthreads();                 // sK's last readers are done
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (tx == 0) sK[ty + 16 * a] = inter[a];
    __syncthreads();
    if (tid < kT && i0 + tid < n) {
      // the column sums and -B . V, written by this thread in sweep A
      float d = dcum[row0 + i0 + tid] + rs + sK[tid];
      if (i0 + tid == n - 1) d += dtot;
      dcum[row0 + i0 + tid] = d;
    }
  }
}

template <typename Tin, int HP, int DS>
int launch(const float* xbar, const void* B, const void* C, const float* cum,
           const float* dy, const float* dh, float* dxbar, void* dB, void* dC,
           float* dcum, float* states, float* partial, int bh, int bh_bc,
           int S, int hd, int chunk, cudaStream_t stream) {
  using L = ChunkLayout<HP, DS>;
  static_assert(L::kBytes <= 232448, "shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_bwd_chunk_kernel<Tin, HP, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int group = bh / bh_bc;
  const int nc = (S + chunk - 1) / chunk;
  const Tin* Bt = static_cast<const Tin*>(B);
  const Tin* Ct = static_cast<const Tin*>(C);
  float* hs = states;
  float* gs = states + static_cast<size_t>(bh) * nc * hd * DS;
  float* dBp = partial;
  float* dCp = partial + static_cast<size_t>(bh) * S * DS;
  ssm_bwd_state_kernel<Tin, DS>
      <<<dim3(bh, (hd + kSRows - 1) / kSRows, 2), kThreads, 0, stream>>>(
          xbar, Bt, Ct, cum, dy, dh, hs, gs, S, hd, group, chunk, nc);
  ssm_bwd_chunk_kernel<Tin, HP, DS><<<dim3(bh, nc), kThreads, L::kBytes,
                                      stream>>>(
      xbar, Bt, Ct, cum, dy, hs, gs, dxbar, dBp, dCp, dcum, S, hd, group,
      chunk, nc);
  const long long E = static_cast<long long>(S) * DS;
  sum_partials<Tin>(dBp, static_cast<Tin*>(dB), bh_bc, E, group, group * E, E,
                    stream);
  sum_partials<Tin>(dCp, static_cast<Tin*>(dC), bh_bc, E, group, group * E, E,
                    stream);
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
      (S + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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
