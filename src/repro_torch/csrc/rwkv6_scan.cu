// rwkv6_scan: the RWKV6 ("Finch") time-mix recurrence with a per-channel,
// data-dependent decay, one sequence per head.
// r, k, v, w (BH, S, hd) bf16 or f32 (w the decay, in (0, 1)), u (NU, hd)
// f32 the per-head bonus (row bh reads u row bh % NU: u is shared by the
// batch). Writes o (BH, S, hd) in the inputs' dtype and the final state
// S (BH, hd, hd) f32, indexed [key i][value j], from a zero initial state:
//   o_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t.
//
// Replaces the Pallas TPU kernel rwkv6_scan / _rwkv_kernel
// (src/repro/kernels/rwkv6_scan.py:46, body :17), which steps the same
// recurrence over (hd, hd) states kept in VMEM across a sequential grid
// of chunks and drops the final state. Blocks on the card have no order,
// so the whole sequence runs inside one block; the chunk was only the
// TPU's tile, so any S is taken.
//
// Bound on an H100: operations. Per state element per step a product
// k_i v_j and three multiply-adds (7 BH S hd^2 flops, f32 on CUDA cores at
// 67 TFLOP/s) against 5 * 4 BH S hd bytes of r, k, v, w and o in f32:
// 0.35 hd = 22 flops a byte at hd = 64, above the f32 ridge of
// 67 / 3.35 = 20.
//
// Design: the value columns j of S are independent chains (column j sees
// only v_t[j]), so a block takes kCols = 16 columns of one head: grid
// (BH, hd / 16), 256 threads, 16 threads a column. Thread q of a column
// keeps the states i = q, q + 16, ... and their bonus u[i] in registers
// for the whole sequence. The inputs of kT = 32 steps (16 at hd 128) are
// staged in shared memory as f32; o_t[j] is summed across the 16 threads
// of the column with shuffles and staged, so each tile's o leaves as one
// coalesced write.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kCols = 16;          // value columns per block
constexpr int kTPC = 16;           // threads per column
constexpr int kThreads = kCols * kTPC;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, T* __restrict__ o,
                  float* __restrict__ s_out, int S, int n_u) {
  constexpr int kNS = HD / kTPC;   // states per thread
  constexpr int kT = HD >= 128 ? 16 : 32;  // steps per staged tile (48 KB)
  __shared__ float sr[kT][HD];
  __shared__ float sk[kT][HD];
  __shared__ float sw[kT][HD];
  __shared__ float sv[kT][kCols];
  __shared__ float so[kT][kCols];

  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kCols;
  const int c = threadIdx.x / kTPC;   // column within the block
  const int q = threadIdx.x % kTPC;   // key slice within the column
  const size_t base = static_cast<size_t>(bh) * S * HD;

  float st[kNS], ur[kNS];
#pragma unroll
  for (int m = 0; m < kNS; ++m) {
    st[m] = 0.f;
    ur[m] = u[static_cast<size_t>(bh % n_u) * HD + q + kTPC * m];
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const bool in = t < n;
      const size_t off = base + static_cast<size_t>(t0 + t) * HD + d;
      sr[t][d] = in ? to_f32(r[off]) : 0.f;
      sk[t][d] = in ? to_f32(k[off]) : 0.f;
      sw[t][d] = in ? to_f32(w[off]) : 0.f;
    }
    for (int i = threadIdx.x; i < kT * kCols; i += kThreads) {
      const int t = i / kCols, cc = i % kCols;
      sv[t][cc] = t < n
          ? to_f32(v[base + static_cast<size_t>(t0 + t) * HD + j0 + cc]) : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][c];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kNS; ++m) {
        const int i = q + kTPC * m;
        const float kv = sk[t][i] * vj;
        acc = fmaf(sr[t][i], fmaf(ur[m], kv, st[m]), acc);
        st[m] = fmaf(sw[t][i], st[m], kv);
      }
#pragma unroll
      for (int off = kTPC / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (q == 0) so[t][c] = acc;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n * kCols; i += kThreads) {
      const int t = i / kCols, cc = i % kCols;
      o[base + static_cast<size_t>(t0 + t) * HD + j0 + cc] = from_f32<T>(so[t][cc]);
    }
    __syncthreads();  // the next tile overwrites the staged inputs and so
  }

#pragma unroll
  for (int m = 0; m < kNS; ++m)
    s_out[(static_cast<size_t>(bh) * HD + q + kTPC * m) * HD + j0 + c] = st[m];
}

template <typename T, int HD>
void launch_hd(const void* r, const void* k, const void* v, const void* w,
               const float* u, void* o, float* s_out, int bh, int S,
               int n_u, cudaStream_t stream) {
  const dim3 grid(bh, HD / kCols);
  rwkv6_scan_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(o), s_out, S, n_u);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* o, float* s_out, int bh, int S, int hd,
           int n_u, cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, 16>(r, k, v, w, u, o, s_out, bh, S, n_u, stream); break;
    case 32: launch_hd<T, 32>(r, k, v, w, u, o, s_out, bh, S, n_u, stream); break;
    case 64: launch_hd<T, 64>(r, k, v, w, u, o, s_out, bh, S, n_u, stream); break;
    case 128: launch_hd<T, 128>(r, k, v, w, u, o, s_out, bh, S, n_u, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* o,
                                void* s_out, int bh, int n_u, int S, int hd,
                                int dtype, void* stream) {
  if (n_u <= 0 || bh % n_u != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* uf = static_cast<const float*>(u);
  float* so = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(r, k, v, w, uf, o, so, bh, S, hd, n_u, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(r, k, v, w, uf, o, so, bh, S, hd, n_u, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
