// decode_attention: single-query attention over a KV cache (flash-decode).
// q (BH, 1, hd), k/v (BH_kv, S, hd) caches, lengths (BH,) int32, out
// (BH, 1, hd); bf16 or f32. Row bh attends to keys 0 .. lengths[bh] - 1
// (and, with a window W, only keys > lengths[bh] - 1 - W) of cache row
// bh / (BH / BH_kv). hd is one of 16, 32, 64, 128, 168 (gemma3-27b) and
// 240 (gemma3-12b).
// A ring cache of W slots (gemma3's local layers) is passed with lengths
// min(pos + 1, W) and no window: the ring holds exactly the keys the
// window keeps, and softmax does not depend on their order.
//
// Replaces the Pallas TPU kernel decode_attention / _decode_kernel
// (src/repro/kernels/decode_attention.py:57, body :22): q pre-scaled by
// 1/sqrt(hd) in f32, f32 partial softmax state, output divided by
// max(l, 1e-30). The Pallas kernel walks every cache block and masks;
// this one reads only the live keys. Lengths must be >= 1 (the serving
// path always has one): at 0 this kernel writes zeros where the Pallas
// kernel averages V over the padded cache.
//
// The logit softcap of the JAX model (repro/models/layers.py _softcap,
// applied in attend_cache): with a cap c > 0 a score becomes c * tanh(s /
// c) before the mask. q is pre-scaled, so the cap acts on the reduced dot.
// It is a template flag (CAP): a cap of 0 compiles to the uncapped
// arithmetic unchanged.
//
// Bound on an H100: bytes. Each live cache entry is read once with 2 * hd
// flops per K row and per V row, about 1 flop per byte in bf16, so the
// least time is 2 * sum(lengths) * hd * sizeof(T) / 3.35 TB/s.
//
// Design: split-K over the cache, two launches from one entry.
// Pass 1 (decode_split_kernel), grid (splits, BH_kv), 4 warps: block
//   (split, kvh) takes keys [split * span, (split + 1) * span) of cache
//   row kvh for each of the G = BH / BH_kv queries that share it, in
//   chunks of 64 keys (16 a warp). Lanes load 16 bytes (8 bf16 / 4 f32 of
//   hd), so hd / 8 lanes cover a bf16 key and a warp covers 32 / (hd / 8)
//   keys a load; all of a warp's K and V loads of a chunk are issued
//   before the first is used. Where a key's 16-byte vectors are not a
//   power of two that divides the warp (hd 240: 30 in bf16, 60 in f32;
//   hd 168: 21 and 42), a key takes the whole warp and each lane up to two
//   vectors, strided by 32 (hd 240: bf16 lanes 30 and 31 idle, f32 lanes
//   28 to 31 idle in the second vector; hd 168: bf16 lanes 21 to 31 idle,
//   f32 lanes 10 to 31 idle in the second vector), and the warp takes its
//   16 keys of a chunk in two
//   batches of 8 at f32, so that K and V in flight stay at 16 vectors a
//   lane. Dot products are reduced within each lane
//   group with shuffles; each group keeps its own (m, l, acc), merged
//   across the warp with shuffles and across the 4 warps in shared memory.
//   Dead keys (past the length or left of the window) are never read. The
//   block writes its partial (acc[hd], m, l) in f32 to the scratch tensor
//   (BH, splits, hd + 2); a split with no live key for a query writes
//   m = -1e30, l = 0. With G > 1 the queries take the block's keys in
//   turn: the first reads them from device memory, the others from L1.
// Pass 2 (decode_combine_kernel), grid BH: reads only the live splits,
//   computed from lengths on the device, and merges them by the rule the
//   warps use: M = max m_i, L = sum l_i e^(m_i - M), A = sum acc_i
//   e^(m_i - M), out = A / max(L, 1e-30). One warp reads every split's
//   (m, l) at once and leaves the weights in shared memory; each thread
//   then sums its dim over the splits with independent loads. It is a
//   programmatic dependent launch: scheduled while pass 1 runs, it waits
//   in griddepcontrol.wait, so its launch latency hides behind pass 1.
// span and splits come from the cache capacity S alone
// (kernels/decode_attention.py plan_splits), so the host never reads
// lengths. At batch 1 (BH 32, S 1024) pass 1 has 16 x 32 = 512 blocks.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;                 // keys a block takes per step
constexpr int kKeysPerWarp = kChunk / kWarps;
constexpr int kMaxSplits = 64;             // decode_attention.py MAX_SPLITS

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 16-byte vectors a key row holds, and how a warp lays them on its lanes
template <typename T, int HD>
struct KeyLayout {
  static constexpr int kVec = 16 / sizeof(T);        // elements a vector
  static constexpr int kRow = HD / kVec;              // vectors a key
  static constexpr bool kFits = kRow <= 32 && 32 % kRow == 0;
  static constexpr int kLPK = kFits ? kRow : 32;      // lanes per key
  static constexpr int kNV = (kRow + kLPK - 1) / kLPK;  // vectors a lane
  static constexpr int kKPL = 32 / kLPK;              // keys per warp load
  static constexpr int kSteps = kKeysPerWarp / kKPL;  // loads a chunk
  static constexpr int kBatch = kSteps * kNV > 16 ? 16 / kNV : kSteps;
  static_assert(HD % kVec == 0 && kKPL <= kKeysPerWarp &&
                kSteps % kBatch == 0, "unsupported hd");
};

template <typename T, int HD, bool CAP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part, int group, int S, int span,
                    int splits, int window, float scale, float cap,
                    float inv_cap) {
  using L = KeyLayout<T, HD>;
  constexpr int kVec = L::kVec, kRow = L::kRow, kLPK = L::kLPK;
  constexpr int kNV = L::kNV, kKPL = L::kKPL, kSteps = L::kSteps;
  constexpr int kBatch = L::kBatch;
  constexpr int kE = kNV * kVec;           // elements a lane holds
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];

  // the combine may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLPK;             // key of the warp load
  const int sub = lane % kLPK;             // vectors sub + n * kLPK
  bool has[kNV];                           // vector n lies inside the row
#pragma unroll
  for (int n = 0; n < kNV; ++n) has[n] = L::kFits || sub + n * kLPK < kRow;
  const int s0 = split * span;
  const int s1 = min(s0 + span, S);
  const uint4* kb = reinterpret_cast<const uint4*>(k + static_cast<size_t>(kvh) * S * HD);
  const uint4* vb = reinterpret_cast<const uint4*>(v + static_cast<size_t>(kvh) * S * HD);

  for (int gi = 0; gi < group; ++gi) {
    const int bh = kvh * group + gi;
    const int len = min(lengths[bh], S);
    const int begin = window > 0 ? max(0, len - window) : 0;
    const int lo = max(s0, begin), hi = min(s1, len);  // live keys
    float* out = part + (static_cast<size_t>(bh) * splits + split) * (HD + 2);
    if (lo >= hi) {                                     // no live key here
      if (threadIdx.x == 0) {
        out[HD] = kNegInf;
        out[HD + 1] = 0.f;
      }
      continue;
    }
    float qf[kE];
    const uint4* qrow = reinterpret_cast<const uint4*>(q + static_cast<size_t>(bh) * HD);
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      float f[kVec];
      unpack(has[n] ? qrow[sub + n * kLPK] : make_uint4(0, 0, 0, 0), f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qf[n * kVec + e] = f[e] * scale;
    }

    float m = kNegInf, l = 0.f, acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    for (int c0 = lo - (lo - s0) % kChunk; c0 < hi; c0 += kChunk) {
#pragma unroll
      for (int b0 = 0; b0 < kSteps; b0 += kBatch) {
        uint4 kr[kBatch][kNV], vr[kBatch][kNV];
        bool live[kBatch];
#pragma unroll
        for (int st = 0; st < kBatch; ++st) {
          const int key = c0 + warp * kKeysPerWarp + (b0 + st) * kKPL + grp;
          live[st] = key >= lo && key < hi;
#pragma unroll
          for (int n = 0; n < kNV; ++n) {
            const bool ld = live[st] && has[n];
            const size_t off = static_cast<size_t>(key) * kRow + sub + n * kLPK;
            kr[st][n] = ld ? kb[off] : make_uint4(0, 0, 0, 0);
            vr[st][n] = ld ? vb[off] : make_uint4(0, 0, 0, 0);
          }
        }
        float s[kBatch];
        float m_new = m;
#pragma unroll
        for (int st = 0; st < kBatch; ++st) {
          float dot = 0.f;
#pragma unroll
          for (int n = 0; n < kNV; ++n) {
            float kf[kVec];
            unpack(kr[st][n], kf);
#pragma unroll
            for (int e = 0; e < kVec; ++e) dot += qf[n * kVec + e] * kf[e];
          }
#pragma unroll
          for (int off = kLPK / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (CAP) dot = cap * tanhf(dot * inv_cap);
          s[st] = live[st] ? dot : kNegInf;
          m_new = fmaxf(m_new, s[st]);
        }
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] *= alpha;
#pragma unroll
        for (int st = 0; st < kBatch; ++st) {
          const float p = live[st] ? expf(s[st] - m_new) : 0.f;
          l += p;
#pragma unroll
          for (int n = 0; n < kNV; ++n) {
            float vf[kVec];
            unpack(vr[st][n], vf);
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[n * kVec + e] += p * vf[e];
          }
        }
        m = m_new;
      }
    }

    // merge the lane groups of the warp (a group that saw no live key has
    // m = -1e30, l = 0, acc = 0 and weighs nothing)
    float mw = m;
#pragma unroll
    for (int off = kLPK; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
    const float f = expf(m - mw);
    l *= f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= f;
#pragma unroll
    for (int off = kLPK; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
        if (has[n]) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            sm_acc[warp][(sub + n * kLPK) * kVec + e] = acc[n * kVec + e];
        }
      }
      if (sub == 0) {
        sm_m[warp] = mw;
        sm_l[warp] = l;
      }
    }
    __syncthreads();
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w]);
    for (int d = threadIdx.x; d < HD; d += kThreads) {
      float at = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) at += sm_acc[w][d] * expf(sm_m[w] - mt);
      out[d] = at;
    }
    if (threadIdx.x == 0) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lt += sm_l[w] * expf(sm_m[w] - mt);
      out[HD] = mt;
      out[HD + 1] = lt;
    }
    __syncthreads();                    // shared memory is reused by gi + 1
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ lengths, T* __restrict__ o,
                      int S, int span, int splits, int window) {
  __shared__ float sm_w[kMaxSplits];
  __shared__ float sm_l;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = min(lengths[bh], S);
  T* orow = o + static_cast<size_t>(bh) * HD;
  if (len <= 0) {                       // no key: zeros (see the note)
    for (int d = tid; d < HD; d += kThreads) orow[d] = from_f32<T>(0.f);
    return;
  }
  const int begin = window > 0 ? max(0, len - window) : 0;
  const int first = begin / span;
  const int n = (len - 1) / span - first + 1;  // live splits, <= kMaxSplits
  const float* pb = part + (static_cast<size_t>(bh) * splits + first) * (HD + 2);
  wait_previous_grid();                 // pass 1 is done
  if (tid < 32) {                       // one warp weighs the splits
    float mi[2], li[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = tid + 32 * h;
      mi[h] = i < n ? pb[i * (HD + 2) + HD] : kNegInf;
      li[h] = i < n ? pb[i * (HD + 2) + HD + 1] : 0.f;
    }
    float mt = fmaxf(mi[0], mi[1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    float lt = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = tid + 32 * h;
      const float w = expf(mi[h] - mt);
      if (i < n) sm_w[i] = w;
      lt += li[h] * w;
    }
    lt = warp_sum(lt);
    if (tid == 0) sm_l = lt;
  }
  __syncthreads();
  const float denom = fmaxf(sm_l, 1e-30f);
  for (int d = tid; d < HD; d += kThreads) {
    float at = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) at += pb[i * (HD + 2) + d] * sm_w[i];
    orow[d] = from_f32<T>(at / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v,
              const int* lengths, float* part, void* o, int bh, int bh_kv,
              int S, int span, int splits, int window, float cap,
              cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const dim3 grid(splits, bh_kv);
  if (cap > 0.f) {
    decode_split_kernel<T, HD, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, part, bh / bh_kv, S, span, splits,
        window, scale, cap, 1.f / cap);
  } else {
    decode_split_kernel<T, HD, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, part, bh / bh_kv, S, span, splits,
        window, scale, 0.f, 0.f);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // programmatic dependent launch: the combine's blocks are scheduled
  // while pass 1 runs and wait in griddepcontrol.wait for its results
  return static_cast<int>(launch_dependent(
      decode_combine_kernel<T, HD>, dim3(bh), dim3(kThreads), 0, stream,
      static_cast<const float*>(part), lengths, static_cast<T*>(o), S, span,
      splits, window));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* part, void* o, int bh, int bh_kv, int S, int hd, int span,
           int splits, int window, float cap, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, lengths, part, o, bh, bh_kv, S, span, splits, window, cap, stream);
    case 32: return launch_hd<T, 32>(q, k, v, lengths, part, o, bh, bh_kv, S, span, splits, window, cap, stream);
    case 64: return launch_hd<T, 64>(q, k, v, lengths, part, o, bh, bh_kv, S, span, splits, window, cap, stream);
    case 128: return launch_hd<T, 128>(q, k, v, lengths, part, o, bh, bh_kv, S, span, splits, window, cap, stream);
    case 168: return launch_hd<T, 168>(q, k, v, lengths, part, o, bh, bh_kv, S, span, splits, window, cap, stream);
    case 240: return launch_hd<T, 240>(q, k, v, lengths, part, o, bh, bh_kv, S, span, splits, window, cap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* part, void* o, int bh, int bh_kv,
                                      int S, int hd, int span, int window,
                                      float softcap, int dtype,
                                      void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0 || S <= 0 || span <= 0 ||
      span % repro::kChunk != 0 || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (S + span - 1) / span;
  if (splits > repro::kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const int* lens = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == repro::kBF16) {
    rc = repro::launch<__nv_bfloat16>(q, k, v, lens, p, o, bh, bh_kv, S, hd, span, splits, window, softcap, s);
  } else if (dtype == repro::kF32) {
    rc = repro::launch<float>(q, k, v, lens, p, o, bh, bh_kv, S, hd, span, splits, window, softcap, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
