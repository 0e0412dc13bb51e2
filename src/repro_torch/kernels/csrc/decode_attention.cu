// decode_attention.cu: flash-decoding of one query token per sequence
// against its KV cache, fp32, GQA, optional logit soft-cap and sliding
// window, with a per-sequence cache length.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// decode_attention_kernel (Pallas body _decode_kernel) and the logsumexp
// combine of its split partials (ops.py, combine_splits).  The JAX model
// computes the same function in plain jnp (models/attention.py,
// _decode_attend via attend_decode); the port's decode step calls this.
//
// Layout: the model's own.  q/o (B, 1, H, D), k/v caches (B, S, Hk, D),
// kv_len (B,) int32, all contiguous; query head h = hk*G + g reads kv head
// hk.  Only the live keys are read: kpos < kv_len and, with a window,
// kpos >= kv_len - window (the reference's kpos > kv_len - 1 - window).
// Positions at or beyond kv_len (right-padded prefill, a slot's stale
// tail) are never touched.
//
// Bound on an H100: bytes.  Each live key costs 2*D*4 bytes of K and V
// against about 4*D operations per query head of its group (G = 2 for
// gemma2), about 1 operation per byte, far below the fp32 ridge (67
// TFLOP/s over 3.35 TB/s = 20).  Gemma2-2b's decode step with one slot at
// 4100 live keys reads ~4096 x 4 x 256 x 2 x 4 B = 33.5 MB per layer, ~10 us.
//
// Design: a grid of (split, kv head, sequence) blocks.  Each sequence's
// live range is cut into `nsplit` equal chunks (rounded up to 32 keys), so
// a long sequence spreads over many SMs while the splits of a short one are
// empty and exit at once.  One block keeps the G query rows of its kv head
// together (q in shared memory), so K and V are read once for all G heads.
// Each of the 8 warps walks its own tiles of 32 keys: lane j scores key j
// against the G rows, each score a sequential chain of fmaf over d = 0 ..
// D-1 scaled after the sum, the plain version's order (the CPU's BLAS and
// cuBLAS sum a dot product the same way).  Without a soft-cap the dense
// zoo's scores reach the hundreds (chatglm3: q std ~11, k std ~45 under the
// reference's init), where any other order (a pre-scaled q, a shuffle tree
// over lanes) rounds a score ~1e-4 away from the plain version's, and a
// near-tied softmax carries that into the logits.  The tile's max and sum
// per row are warp shuffles; for P*V lane l owns head dims l, l+32, ... (at
// D = 16 lanes 16-31 idle, at D = 96 each lane owns three) and p_j is
// broadcast lane to lane.  Running max m, sum l and accumulator per row
// stay in registers; G = 16 (chatglm3, glm4) is built for D <= 128 only
// (16 x D/32 accumulators per lane).  The warps' states are merged in warp
// order in shared memory (deterministic), and the block writes its partial
// (acc, m, l).  A second kernel merges the splits by logsumexp.  An empty
// warp, block or split carries m = -1e30, l = 0, acc = 0 (the reference's
// NEG_INF, never -inf, so no exp(-inf - -inf) = NaN).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per warp tile: lane j scores key j
constexpr int kSplitAlign = kTile;
constexpr int kVRows = 8;  // rows of V loaded ahead in P*V (divides kTile)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// four consecutive floats; 16-byte loads where the base pointer allows
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? __ldg(reinterpret_cast<const float4*>(p))
             : make_float4(p[0], p[1], p[2], p[3]);
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_partials_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ kv_len,
                       float* __restrict__ acc_out,   // (B, Hk, ns, G, D)
                       float* __restrict__ m_out,     // (B, Hk, ns, G)
                       float* __restrict__ l_out,     // (B, Hk, ns, G)
                       int S, int Hk, int window, float cap, float scale,
                       bool vec) {
  constexpr int DT = (D + 31) / 32;  // P*V head dims per lane
  __shared__ __align__(16) float q_s[G][D];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[G][D];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this split's share of the live keys
  const int len = min(kv_len[b], S);
  const int lo = window > 0 ? max(0, kv_len[b] - window) : 0;
  const int live = max(len - lo, 0);
  int chunk = (live + nsplit - 1) / nsplit;
  chunk = (chunk + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
  const int k_beg = lo + split * chunk;
  const int k_end = min(len, k_beg + chunk);

  const float* qb = q + ((size_t)b * Hk + hk) * G * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) q_s[e / D][e % D] = qb[e];
  __syncthreads();

  float acc[G][DT], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[g][t] = 0.0f;
  }

  const size_t kv_row = (size_t)Hk * D;   // stride between positions
  const float* kb = k + ((size_t)b * S * Hk + hk) * D;
  const float* vb = v + ((size_t)b * S * Hk + hk) * D;
  for (int j0 = k_beg + warp * kTile; j0 < k_end; j0 += kWarps * kTile) {
    const int j = j0 + lane;
    const bool ok = j < k_end;
    // key j against the G rows: sequential over d, as the plain version
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) p[g] = 0.0f;
    if (ok) {
      const float* kr = kb + j * kv_row;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = load4(kr + d, vec);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 q4 = *reinterpret_cast<const float4*>(&q_s[g][d]);
          float s = fmaf(q4.x, k4.x, p[g]);
          s = fmaf(q4.y, k4.y, s);
          s = fmaf(q4.z, k4.z, s);
          p[g] = fmaf(q4.w, k4.w, s);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = p[g] * scale;
      if (cap > 0.0f) s = cap * tanhf(s / cap);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));  // lane 0's key is live
      const float alpha = expf(m[g] - m_new);       // 0 on the first tile
      p[g] = ok ? expf(s - m_new) : 0.0f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[g][t] *= alpha;
    }
    // P*V in key order, kVRows rows of V in flight at a time; a key past
    // the tile's live ones has p = 0 and v = 0, so it adds exactly 0
    const int n = min(kTile, k_end - j0);
    for (int u0 = 0; u0 < n; u0 += kVRows) {
      float vv[kVRows][DT];
#pragma unroll
      for (int uu = 0; uu < kVRows; ++uu) {
        const float* vr = vb + (j0 + u0 + uu) * kv_row;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          const int d = lane + 32 * t;
          vv[uu][t] = u0 + uu < n && d < D ? vr[d] : 0.0f;
        }
      }
#pragma unroll
      for (int uu = 0; uu < kVRows; ++uu) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pu = __shfl_sync(kFull, p[g], u0 + uu);
#pragma unroll
          for (int t = 0; t < DT; ++t)
            acc[g][t] = fmaf(pu, vv[uu][t], acc[g][t]);
        }
      }
    }
  }

  // merge the warps' states, in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  for (int e = threadIdx.x; e < G * D; e += kThreads) acc_s[e / D][e % D] = 0.0f;
  __syncthreads();
  float m_blk[G], w_mine[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, m_s[w][g]);
    m_blk[g] = mb;
    w_mine[g] = expf(m[g] - mb);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int t = 0; t < DT; ++t)
          if (lane + 32 * t < D)
            acc_s[g][lane + 32 * t] += acc[g][t] * w_mine[g];
    }
    __syncthreads();
  }
  const size_t part = (((size_t)b * Hk + hk) * nsplit + split) * G;
  for (int e = threadIdx.x; e < G * D; e += kThreads)
    acc_out[part * D + e] = acc_s[e / D][e % D];
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float lb = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      lb += l_s[w][g] * expf(m_s[w][g] - m_blk[g]);
    m_out[part + g] = m_blk[g];
    l_out[part + g] = lb;
  }
}

// One block per (sequence, query head), one thread per head dim: the
// splits' partials merged by logsumexp (combine_splits in the reference).
__global__ void decode_combine_kernel(const float* __restrict__ acc,
                                      const float* __restrict__ m,
                                      const float* __restrict__ l,
                                      float* __restrict__ o, int H, int G,
                                      int D, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / G, g = h % G;
  const size_t base = ((size_t)b * (H / G) + hk) * nsplit;
  float m_glob = kNegInf;
  for (int s = 0; s < nsplit; ++s) m_glob = fmaxf(m_glob, m[(base + s) * G + g]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = (base + s) * G + g;
      const float w = expf(m[i] - m_glob);
      den += l[i] * w;
      num += acc[i * D + d] * w;
    }
    o[((size_t)b * H + h) * D + d] = num / fmaxf(den, 1e-30f);
  }
}

template <int D, int G>
int launch_partials(const float* q, const float* k, const float* v,
                    const int* kv_len, float* acc, float* m, float* l, int B,
                    int S, int Hk, int nsplit, int window, float cap,
                    cudaStream_t stream) {
  const dim3 grid(nsplit, Hk, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  // every row offset is a multiple of 16 floats: only the bases can break
  // 16-byte alignment (a view at an odd offset)
  const bool vec = ((size_t)k | (size_t)v) % 16 == 0;
  decode_partials_kernel<D, G><<<grid, kThreads, 0, stream>>>(
      q, k, v, kv_len, acc, m, l, S, Hk, window, cap, scale, vec);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_g(int G, const float* q, const float* k, const float* v,
               const int* kv_len, float* acc, float* m, float* l, int B,
               int S, int Hk, int nsplit, int window, float cap,
               cudaStream_t st) {
  switch (G) {
    case 1: return launch_partials<D, 1>(q, k, v, kv_len, acc, m, l, B, S, Hk, nsplit, window, cap, st);
    case 2: return launch_partials<D, 2>(q, k, v, kv_len, acc, m, l, B, S, Hk, nsplit, window, cap, st);
    case 4: return launch_partials<D, 4>(q, k, v, kv_len, acc, m, l, B, S, Hk, nsplit, window, cap, st);
    case 8: return launch_partials<D, 8>(q, k, v, kv_len, acc, m, l, B, S, Hk, nsplit, window, cap, st);
    case 16:  // chatglm3 / glm4: 32 query heads over 2 kv heads
      if constexpr (D <= 128)
        return launch_partials<D, 16>(q, k, v, kv_len, acc, m, l, B, S, Hk, nsplit, window, cap, st);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D), k/v (B, S, Hk, D) float32, kv_len (B,) int32, contiguous.
// Writes the split partials acc (B, Hk, nsplit, G, D), m and l
// (B, Hk, nsplit, G).  cap <= 0 means no soft-cap, window <= 0 none.
extern "C" int decode_attention_partials_f32(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* acc, void* m, void* l, int B, int S, int H, int Hk, int D,
    int nsplit, float cap, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || nsplit <= 0 || B > 65535 ||
      Hk > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const int* len = (const int*)kv_len;
  float* a = (float*)acc;
  float* mm = (float*)m;
  float* ll = (float*)l;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return dispatch_g<16>(G, qf, kf, vf, len, a, mm, ll, B, S, Hk, nsplit, window, cap, st);
    case 32: return dispatch_g<32>(G, qf, kf, vf, len, a, mm, ll, B, S, Hk, nsplit, window, cap, st);
    case 64: return dispatch_g<64>(G, qf, kf, vf, len, a, mm, ll, B, S, Hk, nsplit, window, cap, st);
    case 96: return dispatch_g<96>(G, qf, kf, vf, len, a, mm, ll, B, S, Hk, nsplit, window, cap, st);
    case 128: return dispatch_g<128>(G, qf, kf, vf, len, a, mm, ll, B, S, Hk, nsplit, window, cap, st);
    case 256: return dispatch_g<256>(G, qf, kf, vf, len, a, mm, ll, B, S, Hk, nsplit, window, cap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The splits' partials -> o (B, H, D).
extern "C" int decode_attention_combine_f32(const void* acc, const void* m,
                                            const void* l, void* o, int B,
                                            int H, int Hk, int D, int nsplit,
                                            void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk || nsplit <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  const int threads = D < 256 ? D : 256;
  decode_combine_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)acc, (const float*)m, (const float*)l, (float*)o, H,
      H / Hk, D, nsplit);
  return (int)cudaGetLastError();
}
