// flash_attention_bwd.cu: the gradient of flash_attention.cu's function,
// dQ, dK and dV of GQA attention with a softmax over scaled (and optionally
// soft-capped) logits, causal or bidirectional, optional sliding window,
// fp32.
//
// Replaces no Pallas kernel: the TPU package has no backward kernel (its
// training differentiates the plain jnp attention,
// src/repro/models/attention.py, full_attention).  It was added so that
// the port trains on the card through the forward kernel
// (src/repro/kernels/flash_attention/kernel.py, flash_attention_kernel,
// ported as flash_attention.cu): the stream MLLMs' pretraining and the
// dense LMs' training (kernels/flash_attention/ops.py, FlashAttentionFn).
//
// The function, per query row i of head h and key j of its kv head
// (GQA: G = H/Hk consecutive query heads share one):
//   s_ij = scale * q_i.k_j (scale 1/sqrt(D)); with a cap, c_ij = cap *
//   tanh(s_ij / cap), else c_ij = s_ij; P_ij = exp(c_ij - lse_i) where j is
//   visible (causal: j <= i; window: j > i - window), else 0; o_i =
//   sum_j P_ij v_j.  lse is the forward's (flash_attention_lse_f32).
// Its gradient, with dO the gradient of o:
//   delta_i = dO_i.o_i;  dP_ij = dO_i.v_j;  dC_ij = P_ij (dP_ij - delta_i);
//   dS_ij = dC_ij (1 - (c_ij/cap)^2) with a cap (the derivative of the
//   capped logit, from the capped value), else dC_ij;
//   dV_j = sum_i P_ij dO_i;  dK_j = scale sum_i dS_ij q_i;
//   dQ_i = scale sum_j dS_ij k_j.
// dK and dV sum over the queries of all G heads of the group.
//
// Bound on an H100: 10 D fp32 operations per visible (query, key) pair
// (Q.K^T recomputed, dO.V^T, dV, dK, dQ: five products of 2 D) and 4 bytes
// per element of q, k, v, o, dO, lse and dq, dk, dv, each read or written
// once.  At chatglm3-6b's micro-batch (B 8, S 64, H 32/2, D 128, causal:
// 0.53 M visible pairs) that is 0.68 GFLOP, 4.1 us at the tensor cores'
// 3xTF32 rate (165 fp32 TFLOP/s), against 35.7 MB, 10.7 us at 3.35 TB/s;
// at the stream MLLM's full frame (B 16, S 140, H 8/4, D 32: 1.26 M
// pairs) 0.40 GFLOP, 2.5 us, against 13.8 MB, 4.1 us: bytes bound both.
// This kernel runs its products on the CUDA cores (67 TFLOP/s) and reads
// each K/V tile once per query tile, so neither bound is its own.
//
// Design (simple, right first): three launches on the caller's stream.
//  1. flash_bwd_delta: delta_i = dO_i.o_i, a warp a (row, head), into a
//     (B, H, S) scratch the wrapper allocates.
//  2. flash_bwd_dkdv: a block of 256 threads per (tile of BN = 32 keys,
//     kv head, batch row).  K and V of the tile stay in shared memory; the
//     block loops over the G heads of the group and, for each, over the
//     tiles of BM = 32 queries that can see a key of the tile (from the
//     tile's first key on when causal, up to its last key + window - 1
//     under a window), so dK and dV sum the whole group in registers
//     without atomics.  For each query tile: Q, dO, lse and delta into
//     shared memory; P and dS recomputed (a warp a query row, a lane a
//     key: the lane's K and V rows read as float4 at a row stride of D+4
//     floats, free of bank conflicts; q and dO broadcast) into shared
//     tiles; then each thread adds P^T.dO and dS^T.Q for its (key, d)
//     pairs (d = thread mod D where D divides 256, so one dO and one Q
//     load serve all of the thread's keys).  The sums run in three levels,
//     so that no chain of fp32 additions is long (one chain of G x S
//     terms, 8320 at G 64, S 130, was 6x farther from float64 than the
//     plain version's autograd): a fresh sum per query tile, added to the
//     head's sum, added after each head to the group's total in shared
//     memory (each thread its own slots).
//  3. flash_bwd_dq: a block per (tile of BM queries, query head, batch
//     row), looping over the key tiles the forward visits for those rows
//     (the same range as flash_attention.cu's), dS recomputed the same
//     way, dQ += dS.K in registers (a fresh sum per key tile, added to
//     the total).  Each score and dO.v sums D products in four chains.
// Every sum runs in a fixed order (fp32 FMA on the CUDA cores, no
// atomics), so a launch repeats the last one bit for bit.  Rows and keys
// past S load zeros and are masked (P = 0) and never stored.  Shared
// memory is 4 (32 x (D+4)) + 2 (32 x 33) + 64 floats, and 2 (32 x D) more
// for dK/dV's totals: 207,360 bytes at D = 256, above the 48 KB default,
// so each launch raises the kernel's limit first.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 32;        // query rows per tile
constexpr int BN = 32;        // keys per tile (a lane each in the P pass)
constexpr int LP = BN + 1;    // row stride of the P and dS tiles
constexpr int RPW = BM / kWarps;  // query rows per warp in the P pass
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;  // row stride of the Q, dO, K, V tiles
  // where D divides the block, a thread's pairs share one d
  static constexpr bool DFIX = kThreads % D == 0;
  static constexpr int NKV = BN * D / kThreads;  // (key, d) pairs a thread
  static constexpr int NQ = BM * D / kThreads;   // (query, d) pairs a thread
  // the tiles, then dK's and dV's group totals (flash_bwd_dkdv only)
  static constexpr size_t smem_dq =
      sizeof(float) *
      ((size_t)2 * (BM + BN) * LD + (size_t)2 * BM * LP + 2 * BM);
  static constexpr size_t smem_dkdv =
      smem_dq + sizeof(float) * (size_t)2 * BN * D;
};

// rows p0 .. p0+R-1 of head h of a (B, S, NH, D) tensor into dst (row
// stride D+4); zeros past S
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int S, int NH, int h, int p0,
                                          bool vec) {
  constexpr int LD = Cfg<D>::LD;
  if (vec) {
    constexpr int W = D / 4;
    for (int e = threadIdx.x; e < R * W; e += kThreads) {
      const int r = e / W, c = (e % W) * 4, pos = p0 + r;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (pos < S)
        x = __ldg(reinterpret_cast<const float4*>(
            src + (((size_t)b * S + pos) * NH + h) * D + c));
      *reinterpret_cast<float4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kThreads) {
      const int r = e / D, c = e % D, pos = p0 + r;
      dst[r * LD + c] =
          pos < S ? __ldg(src + (((size_t)b * S + pos) * NH + h) * D + c)
                  : 0.0f;
    }
  }
}

// lse and delta of rows q0 .. q0+BM-1 of head h (0 past S)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int b, int S, int H, int h,
                                               int q0) {
  if (threadIdx.x < BM) {
    const int pos = q0 + threadIdx.x;
    const size_t at = ((size_t)b * H + h) * S + pos;
    lse_s[threadIdx.x] = pos < S ? lse[at] : 0.0f;
    dl_s[threadIdx.x] = pos < S ? delta[at] : 0.0f;
  }
}

// The P pass: for query rows q0 + i (i = warp + kWarps r) and key k0 +
// lane, P and dS (the gradient of the raw score s, before the scale) into
// the shared tiles (P only when p_s is not null).
template <int D>
__device__ __forceinline__ void p_pass(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       const float* lse_s, const float* dl_s,
                                       float* p_s, float* ds_s, int q0, int k0,
                                       int S, int causal, float cap,
                                       int window, float scale) {
  constexpr int LD = Cfg<D>::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // four partial sums per dot product (d mod 4), added pairwise at the
  // end: chains of D/4 products, not D
  float s[RPW][4], dp[RPW][4];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(k_s + lane * LD + d);
    const float4 vv = *reinterpret_cast<const float4*>(v_s + lane * LD + d);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp + kWarps * r;
      const float4 qq = *reinterpret_cast<const float4*>(q_s + i * LD + d);
      const float4 oo = *reinterpret_cast<const float4*>(do_s + i * LD + d);
      s[r][0] = fmaf(qq.x, kk.x, s[r][0]);
      s[r][1] = fmaf(qq.y, kk.y, s[r][1]);
      s[r][2] = fmaf(qq.z, kk.z, s[r][2]);
      s[r][3] = fmaf(qq.w, kk.w, s[r][3]);
      dp[r][0] = fmaf(oo.x, vv.x, dp[r][0]);
      dp[r][1] = fmaf(oo.y, vv.y, dp[r][1]);
      dp[r][2] = fmaf(oo.z, vv.z, dp[r][2]);
      dp[r][3] = fmaf(oo.w, vv.w, dp[r][3]);
    }
  }
  const int kpos = k0 + lane;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp + kWarps * r, qpos = q0 + i;
    const bool vis = qpos < S && kpos < S && (!causal || kpos <= qpos) &&
                     (window <= 0 || kpos > qpos - window);
    float x = ((s[r][0] + s[r][1]) + (s[r][2] + s[r][3])) * scale;
    if (cap > 0.0f) x = cap * tanhf(x / cap);
    const float p = vis ? expf(x - lse_s[i]) : 0.0f;
    const float dpr = (dp[r][0] + dp[r][1]) + (dp[r][2] + dp[r][3]);
    float ds = p * (dpr - dl_s[i]);
    if (cap > 0.0f) {
      const float t = x / cap;
      ds *= 1.0f - t * t;
    }
    if (p_s != nullptr) p_s[i * LP + lane] = p;
    ds_s[i * LP + lane] = ds;
  }
}

// delta_i = dO_i.o_i, a warp a (position, head) row of the (B, S, H, D)
// layout, into delta (B, H, S)
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta, long long rows, int S, int H,
                int D) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + row * D;
  const float* drow = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(drow[d], orow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % S), b = (int)(bs / S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int S, int H,
               int Hk, int G, int causal, float cap, int window, float scale,
               bool vec) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, NKV = C::NKV;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // [BN][LD]
  float* v_s = k_s + BN * LD;     // [BN][LD]
  float* q_s = v_s + BN * LD;     // [BM][LD]
  float* do_s = q_s + BM * LD;    // [BM][LD]
  float* p_s = do_s + BM * LD;    // [BM][LP]
  float* ds_s = p_s + BM * LP;    // [BM][LP]
  float* lse_s = ds_s + BM * LP;  // [BM]
  float* dl_s = lse_s + BM;       // [BM]

  const int k0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  load_rows<D, BN>(k_s, k, b, S, Hk, hk, k0, vec);
  load_rows<D, BN>(v_s, v, b, S, Hk, hk, k0, vec);

  // dK and dV sum up to G x S terms, in three levels so that no chain is
  // long: a fresh sum per query tile (BM terms), added to the head's sum,
  // added after each head to the group's total, which each thread keeps
  // in its own slots of shared memory
  float* tot_k = dl_s + BM;                 // [NKV][kThreads]
  float* tot_v = tot_k + NKV * kThreads;    // [NKV][kThreads]
#pragma unroll
  for (int n = 0; n < NKV; ++n)
    tot_k[n * kThreads + t] = tot_v[n * kThreads + t] = 0.0f;

  // the queries that can see a key of the tile
  const int klast = min(S, k0 + BN) - 1;
  const int qbeg = causal ? k0 : 0;
  const int qend = window > 0 ? min(S, klast + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    float hsum_k[NKV], hsum_v[NKV];
#pragma unroll
    for (int n = 0; n < NKV; ++n) hsum_k[n] = hsum_v[n] = 0.0f;
    for (int q0 = qbeg; q0 < qend; q0 += BM) {
      __syncthreads();  // the last tile's readers are done
      load_rows<D, BM>(q_s, q, b, S, H, h, q0, vec);
      load_rows<D, BM>(do_s, dout, b, S, H, h, q0, vec);
      load_row_stats(lse_s, dl_s, lse, delta, b, S, H, h, q0);
      __syncthreads();
      p_pass<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, k0, S,
                causal, cap, window, scale);
      __syncthreads();
      // dV += P^T.dO, dK += dS^T.Q over the tile's queries
      float tk[NKV], tv[NKV];
#pragma unroll
      for (int n = 0; n < NKV; ++n) tk[n] = tv[n] = 0.0f;
      if constexpr (C::DFIX) {
        constexpr int J = kThreads / D;
        const int d = t % D, j0 = t / D;
        for (int i = 0; i < BM; ++i) {
          const float od = do_s[i * LD + d], qd = q_s[i * LD + d];
#pragma unroll
          for (int n = 0; n < NKV; ++n) {
            const int j = j0 + J * n;
            tv[n] = fmaf(p_s[i * LP + j], od, tv[n]);
            tk[n] = fmaf(ds_s[i * LP + j], qd, tk[n]);
          }
        }
      } else {
        for (int i = 0; i < BM; ++i) {
#pragma unroll
          for (int n = 0; n < NKV; ++n) {
            const int e = t + kThreads * n, j = e / D, d = e % D;
            tv[n] = fmaf(p_s[i * LP + j], do_s[i * LD + d], tv[n]);
            tk[n] = fmaf(ds_s[i * LP + j], q_s[i * LD + d], tk[n]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NKV; ++n) {
        hsum_k[n] += tk[n];
        hsum_v[n] += tv[n];
      }
    }
#pragma unroll
    for (int n = 0; n < NKV; ++n) {
      tot_k[n * kThreads + t] += hsum_k[n];
      tot_v[n * kThreads + t] += hsum_v[n];
    }
  }
#pragma unroll
  for (int n = 0; n < NKV; ++n) {
    const int e = C::DFIX ? (t % D) + D * (t / D + (kThreads / D) * n)
                          : t + kThreads * n;
    const int j = e / D, d = e % D, pos = k0 + j;
    if (pos < S) {
      const size_t at = (((size_t)b * S + pos) * Hk + hk) * D + d;
      dk[at] = tot_k[n * kThreads + t] * scale;
      dv[at] = tot_v[n * kThreads + t];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int S, int H, int Hk, int G, int causal,
             float cap, int window, float scale, bool vec) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, NQ = C::NQ;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // [BN][LD]
  float* v_s = k_s + BN * LD;     // [BN][LD]
  float* q_s = v_s + BN * LD;     // [BM][LD]
  float* do_s = q_s + BM * LD;    // [BM][LD]
  float* ds_s = do_s + BM * LD + BM * LP;  // [BM][LP] (the layout's P tile
                                          // is unused here)
  float* lse_s = ds_s + BM * LP;  // [BM]
  float* dl_s = lse_s + BM;       // [BM]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G, t = threadIdx.x;
  load_rows<D, BM>(q_s, q, b, S, H, h, q0, vec);
  load_rows<D, BM>(do_s, dout, b, S, H, h, q0, vec);
  load_row_stats(lse_s, dl_s, lse, delta, b, S, H, h, q0);

  float aq[NQ];
#pragma unroll
  for (int n = 0; n < NQ; ++n) aq[n] = 0.0f;

  // the keys any row of the tile sees (flash_attention.cu's range)
  const int kend = causal ? min(S, q0 + BM) : S;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = kbeg; k0 < kend; k0 += BN) {
    __syncthreads();  // the last tile's readers are done
    load_rows<D, BN>(k_s, k, b, S, Hk, hk, k0, vec);
    load_rows<D, BN>(v_s, v, b, S, Hk, hk, k0, vec);
    __syncthreads();
    p_pass<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, q0, k0, S,
              causal, cap, window, scale);
    __syncthreads();
    // dQ += dS.K over the tile's keys: a fresh sum per key tile, added to
    // the total (no chain longer than BN or the count of tiles)
    float tq[NQ];
#pragma unroll
    for (int n = 0; n < NQ; ++n) tq[n] = 0.0f;
    if constexpr (C::DFIX) {
      constexpr int I = kThreads / D;
      const int d = t % D, i0 = t / D;
      for (int j = 0; j < BN; ++j) {
        const float kd = k_s[j * LD + d];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          tq[n] = fmaf(ds_s[(i0 + I * n) * LP + j], kd, tq[n]);
      }
    } else {
      for (int j = 0; j < BN; ++j) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int e = t + kThreads * n, i = e / D, d = e % D;
          tq[n] = fmaf(ds_s[i * LP + j], k_s[j * LD + d], tq[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n) aq[n] += tq[n];
  }
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int e = C::DFIX ? (t % D) + D * (t / D + (kThreads / D) * n)
                          : t + kThreads * n;
    const int i = e / D, d = e % D, pos = q0 + i;
    if (pos < S) dq[(((size_t)b * S + pos) * H + h) * D + d] = aq[n] * scale;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int B, int S, int H, int Hk, int causal,
           float cap, int window, cudaStream_t stream) {
  const size_t smem_kv = Cfg<D>::smem_dkdv, smem_q = Cfg<D>::smem_dq;
  if (smem_kv > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_kv);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem_q > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_q);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) & 15u) == 0;
  const int G = H / Hk;
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long rows = (long long)B * S * H;
  flash_bwd_delta<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                    stream>>>(o, dout, delta, rows, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<D><<<dim3((S + BN - 1) / BN, Hk, B), kThreads, smem_kv,
                      stream>>>(q, k, v, dout, lse, delta, dk, dv, S, H, Hk,
                                G, causal, cap, window, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<D><<<dim3((S + BM - 1) / BM, H, B), kThreads, smem_q,
                    stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, Hk, G, causal, cap, window, scale,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, S, H, D); k, v, dk, dv (B, S, Hk, D); lse and the
// scratch delta (B, H, S); all float32 contiguous.  lse is
// flash_attention_lse_f32's for the same q, k, v and options.  cap <= 0
// means no soft-cap, window <= 0 no sliding window.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int B, int S, int H, int Hk,
                                       int D, int causal, float cap,
                                       int window, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* of = (const float*)o;
  const float* gf = (const float*)dout;
  const float* lf = (const float*)lse;
  float* df = (float*)delta;
  float* dqf = (float*)dq;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BWD_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return launch<DIM>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, B, S, H,   \
                       Hk, causal, cap, window, st);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
