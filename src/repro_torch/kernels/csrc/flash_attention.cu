// flash_attention.cu: forward GQA attention with an online softmax, fp32,
// causal or bidirectional, optional logit soft-cap and sliding window.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (Pallas body _flash_kernel).  The JAX stream MLLM
// computes the same function in plain jnp (models/attention.py,
// full_attention via attend_prefill); the port's MLLM and the served LMs'
// prefill call this kernel.
//
// Layout: the model's own, q/o (B, Sq, H, D) and k/v (B, Sk, Hk, D), all
// contiguous.  GQA puts G = H/Hk consecutive query heads on one kv head.
// Sq and Sk differ only without a positional mask (causal 0, no window):
// cross attention, Sq decoder tokens against the Sk frames of an
// encoder's output (the wrapper refuses the rest).  The key loop runs to
// Sk and masks the last tile's tail at Sk; the query tiles, the output
// and lse are Sq rows.  At Sq == Sk the code is the square kernel's.
//
// Bound on an H100: 4*D fp32 operations per visible (query, key) pair
// (Q.K^T and P.V) and 4 bytes per element of q, k, v and o.  The least
// time the card could take for them is at the tensor cores: with each
// fp32 product as three TF32 products (3xTF32), 3 x 4*D operations per
// pair at the TF32 peak of 495 TFLOP/s, 165 fp32 TFLOP/s, against 67 on
// the CUDA cores.  At a causal prefill of 8192 (phi3-mini, H 32, D 96)
// that is 412 GFLOP, 2.5 ms; at the MLLM's full frame (B 16, S 140, H
// 8/4, D 32) 162 MFLOP against 6.9 MB, bytes bound it at 2.1 us and the
// launch at about as much.  This kernel runs 4.5 TF32 products per fp32
// product on average (below), and mma.sync (not wgmma) reaches about 300
// TFLOP/s of TF32 on an H100 (scripts/mma_sync_rate.py), so its own
// ceiling is about 67 fp32 TFLOP/s.
//
// Precision: TF32 keeps 10 of fp32's 23 mantissa bits, so one TF32
// product would miss the fp32 tolerance the plain version is held to.
// Each operand is split instead into TF32 parts by Veltkamp's split
// (three fp32 operations: hi is x rounded to 11 significant bits, lo the
// rest, exact).  Q.K^T runs 3xTF32, hi*hi + hi*lo + lo*hi, as PyTorch's
// memory-efficient SDPA does for fp32 through CUTLASS's
// OpMultiplyAddFastF32: two parts hold 22 of x's 24 bits (the tensor
// cores read lo's top 11), so each product is off by about 2^-22, but a
// score sums D products and fp32's own summation error is larger there.
// P.V is different: behind a dominant key an output is one product,
// which fp32 rounds once (2^-24), and 3xTF32's 2^-22 misses fp32's
// accuracy there (tests/test_torch_flash_split.py).  So P and V are split
// in three exact parts (hi, mid, and lo, the last 2 bits) and
// P.V runs six terms, hi*hi, hi*mid, mid*hi, mid*mid, hi*lo and lo*hi,
// dropping only terms below 2^-33 of the product (twice Q.K^T's
// products per pair).  The tensor cores sum with less care than fp32
// adds, so no accumulator gathers many terms: Q.K^T's cross terms, about
// 2^-11 of the sum, have their own; hi*hi is summed 16 products at a time
// (two d steps) in a fresh accumulator and added to S with an fp32 add;
// P.V's tile sums are added to O the same way.  At the dense zoo's
// magnitudes (scores in the hundreds) the result is nearer float64 than
// the plain version is; without the staging it is farther.  The sums no
// longer run in the plain version's order.
//
// Design (FlashAttention-2 on mma.sync.m16n8k8.tf32): one block of 8
// warps per (query tile, kv head, batch row).  The tile holds the G*BQ
// query rows (G heads x BQ positions, BQ = 128/G, at most 128 rows) that
// share the kv head, so K/V are read once per tile; each warp owns 16
// rows.  Q stays in shared memory and is split as it is read; K and V
// stream through one shared buffer each, in tiles of 32 keys (16 at D =
// 256, for shared memory), with cp.async: V(j) loads while S = Q.K(j)^T
// is computed, K(j+1) while P.V(j) is.  Once a tile lands, the block
// splits it in place (hi over the loaded values, the other parts beside
// them), once for all 8 warps, so the fragment loads read ready TF32
// operands; at D 96 and 128 V keeps only hi and the exact rest, which
// P.V splits as it reads it, so that 32-key tiles fit two blocks (D 96)
// or one (D 128) on an SM.  Up to D 96 the registers are capped at 128 a
// thread for two blocks an SM (ptxas otherwise takes up to 208 and one).
// Q's and K's rows are padded by 8 floats and V's by 4, so the fragment
// loads are free of bank conflicts (64-bit for Q and K, 32-bit for V).
// In Q.K^T, k-index t of each 8-wide d step stands for d = 2t and t+4 for
// d = 2t+1, so a lane's two values of a row are adjacent.  S lives in mma
// accumulator fragments: scale, cap (cap * tanh(s / cap)), mask and the
// online softmax run on them, the row max reduced across the four lanes
// of a row; each thread keeps a partial row sum l, reduced at the end.  P
// goes to the P.V product without a shuffle: the accumulator holds keys
// 2t and 2t+1 where the A fragment wants k-indices t and t+4, so P.V's
// k-index t stands for key 2t and t+4 for key 2t+1, and V's fragment is
// read from those rows.  P.V runs four d tiles at a time, so eight
// accumulators are in flight (an mma on the accumulator of the one before
// it waits for it).  O stays in registers and is divided by l at the
// end.  No atomics and no split over keys: one input gives one output,
// run to run.  Q tiles run in reverse order, so the longest causal rows
// start first.  From D = 64 the shared memory (up to 218,880 bytes at D =
// 256) exceeds the 48 KB default, and the launch raises the kernel's
// limit first.  Key tiles wholly above the causal diagonal or below the
// window are never loaded, and a warp skips the products of a tile none
// of its rows sees; ragged edges (any Sq, Sk) are masked in the kernel,
// never padded: rows past Sq and keys past Sk load zeros and are masked
// out of the softmax.
//
// Two entry points run this kernel: flash_attention_f32 (serving, no
// log-sum-exp) and flash_attention_lse_f32 (training), which also writes
// each live row's m + log l, the log-sum-exp of its scaled and capped
// logits, for the backward (flash_attention_bwd.cu).  A third,
// flash_attention_bf16, serves bf16 inputs with a kernel of its own
// (flash_fwd_bf16_kernel, below, on wgmma, TMA and mbarriers; the Pallas
// kernel's bf16 half): 2 bytes an element, its operations at the bf16
// tensor cores' 989 TFLOP/s.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace tf32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // query rows per block, 16 per warp
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 16 : 32;  // keys per tile
  // V's mid and lo split from the exact fp32 rest as P.V reads it, not
  // stored: shared memory for 32-key tiles at D 96 and 128
  static constexpr bool VREST = D == 96 || D == 128;
  // blocks per SM the registers must allow (2 caps them at 128 a thread)
  static constexpr int MINB = D <= 96 ? 2 : 1;
  static constexpr int LQ = D + 8;  // Q and K row stride (floats), 64-bit loads
  static constexpr int LV = D + 4;  // V row stride, 32-bit loads
  static constexpr int NT = BK / 8;             // 8-key column tiles of S
  static constexpr int DK = D / 8;              // 8-wide steps over D
  static constexpr int DG = DK < 4 ? DK : 4;    // d tiles of O per P.V pass
  // Q; K's hi and lo; V's hi, lo and mid (or hi and its rest)
  static constexpr size_t smem =
      sizeof(float) * ((size_t)(kRows + 2 * BK) * LQ +
                       (size_t)(VREST ? 2 : 3) * BK * LV);
};

// keys k0 .. k0+BK-1 of kv head hk into s (zeros past Sk)
template <int D, int LD>
__device__ __forceinline__ void load_keys(float* s, const float* src, int b,
                                          int Sk, int Hk, int hk, int k0,
                                          bool vec) {
  const int w = vec ? 4 : 1, per_row = D / w;
  for (int e = threadIdx.x; e < Cfg<D>::BK * per_row; e += kThreads) {
    const int j = e / per_row, c = (e % per_row) * w, pos = k0 + j;
    const bool ok = pos < Sk;
    cp_async(s + j * LD + c,
             ok ? src + (((size_t)b * Sk + pos) * Hk + hk) * D + c : src, ok,
             vec);
  }
}

// N floats of a landed tile split in place: hi over the raw values, the
// exact rest beside them, which the tensor cores read as its TF32 lo (the
// padding columns are split too: they are never read)
template <int N>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  for (int e = threadIdx.x * 4; e < N; e += kThreads * 4) {
    const float4 x = *reinterpret_cast<const float4*>(hi + e);
    float4 h, l;
    splitf(x.x, h.x, l.x);
    splitf(x.y, h.y, l.y);
    splitf(x.z, h.z, l.z);
    splitf(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + e) = h;
    *reinterpret_cast<float4*>(lo + e) = l;
  }
}

template <int N>
__device__ __forceinline__ void split_tile3(float* hi, float* mid, float* lo) {
  for (int e = threadIdx.x * 4; e < N; e += kThreads * 4) {
    const float4 x = *reinterpret_cast<const float4*>(hi + e);
    float4 h, m, l;
    split3f(x.x, h.x, m.x, l.x);
    split3f(x.y, h.y, m.y, l.y);
    split3f(x.z, h.z, m.z, l.z);
    split3f(x.w, h.w, m.w, l.w);
    *reinterpret_cast<float4*>(hi + e) = h;
    *reinterpret_cast<float4*>(mid + e) = m;
    *reinterpret_cast<float4*>(lo + e) = l;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MINB)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk,
                 int H, int Hk, int G, int BQ, int causal, float cap,
                 int window, float scale, bool vec) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, LQ = C::LQ, LV = C::LV, NT = C::NT, DK = C::DK,
                DG = C::DG;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // [kRows][LQ]
  float* k_s = q_s + kRows * LQ;     // [BK][LQ]: K as loaded, then its hi
  float* k_lo = k_s + BK * LQ;       // [BK][LQ]
  float* v_s = k_lo + BK * LQ;       // [BK][LV]: V as loaded, then its hi
  float* v_lo = v_s + BK * LV;       // [BK][LV]: lo, or the rest (VREST)
  float* v_mid = v_lo + BK * LV;     // [BK][LV], unless VREST

  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int R = G * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column group

  // query rows: row r = g*BQ + i is position q0+i of head hk*G+g
  {
    const int w = vec ? 4 : 1, per_row = D / w;
    for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row, c = (e % per_row) * w;
      const int pos = q0 + r % BQ;
      const bool ok = r < R && pos < Sq;
      cp_async(q_s + r * LQ + c,
               ok ? q + (((size_t)b * Sq + pos) * H + hk * G + r / BQ) * D + c
                  : q,
               ok, vec);
    }
  }
  // keys any row of this tile can see
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  kbeg -= kbeg % BK;
  load_keys<D, LQ>(k_s, k, b, Sk, Hk, hk, kbeg, vec);
  cp_commit();

  // this thread's two rows (fragment rows gq and gq+8 of the warp's 16)
  int qpos[2];
  bool live[2];
  int lo_pos = INT_MAX, hi_pos = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    qpos[i] = q0 + r % BQ;
    live[i] = r < R && qpos[i] < Sq;
    if (live[i]) {
      lo_pos = min(lo_pos, qpos[i]);
      hi_pos = max(hi_pos, qpos[i]);
    }
  }
  lo_pos = __reduce_min_sync(kFull, lo_pos);
  hi_pos = __reduce_max_sync(kFull, hi_pos);

  // In Q.K^T, k-index t of each 8-wide d step stands for d = 2t and t+4
  // for d = 2t+1, so a lane's two values of a row are adjacent (one
  // 64-bit load); Q and K agree on it, so the sum is the same.
  const int qoff = (warp * 16 + gq) * LQ + 2 * tq;
  float oacc[DK][4];
#pragma unroll
  for (int dt = 0; dt < DK; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    load_keys<D, LV>(v_s, v, b, Sk, Hk, hk, k0, vec);
    cp_commit();
    cp_wait<1>();  // Q and K(k0) have landed
    __syncthreads();
    split_tile<BK * LQ>(k_s, k_lo);
    __syncthreads();
    // does any row of this warp see a key of the tile?
    const bool work = hi_pos >= 0 && (!causal || k0 <= hi_pos) &&
                      (window <= 0 || k0 + BK - 1 > lo_pos - window);
    uint32_t phi[NT][4], pmi[NT][4], plo[NT][4];
    float alpha[2];
    if (work) {
      // S = Q.K^T: the cross terms (hi*lo, lo*hi) in one accumulator over
      // all of D; hi*hi in a fresh one per two d steps, added to s after
      float s[NT][4], sx[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = sx[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DK; kk += 2) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o0 = qoff + (kk + h) * 8;
          split2(*reinterpret_cast<const float2*>(q_s + o0), ahi[h][0],
                 alo[h][0], ahi[h][2], alo[h][2]);
          split2(*reinterpret_cast<const float2*>(q_s + o0 + 8 * LQ),
                 ahi[h][1], alo[h][1], ahi[h][3], alo[h][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int ko = (nt * 8 + gq) * LQ + kk * 8 + 2 * tq;
          float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 bh = *reinterpret_cast<const uint2*>(k_s + ko + h * 8);
            const uint2 bl = *reinterpret_cast<const uint2*>(k_lo + ko + h * 8);
            mma(sx[nt], alo[h], bh.x, bh.y);
            mma(sx[nt], ahi[h], bl.x, bl.y);
            mma(t, ahi[h], bh.x, bh.y);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += t[e];
        }
      }
      // scale, cap, mask; s[nt][e] is row gq + 8*(e>>1), key
      // k0 + nt*8 + 2*tq + (e&1)
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kpos = k0 + nt * 8 + 2 * tq + (e & 1);
          float x = (s[nt][e] + sx[nt][e]) * scale;
          if (cap > 0.0f) x = cap * tanhf(x / cap);
          const bool vis = live[i] && kpos < Sk &&
                           (!causal || kpos <= qpos[i]) &&
                           (window <= 0 || kpos > qpos[i] - window);
          s[nt][e] = vis ? x : -INFINITY;
          tmax[i] = fmaxf(tmax[i], s[nt][e]);
        }
      float mu[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 2));
        const float m_new = fmaxf(m[i], tmax[i]);
        mu[i] = m_new == -INFINITY ? 0.0f : m_new;  // a row seeing nothing yet
        alpha[i] = expf(m[i] - mu[i]);              // 0 before its first key
        m[i] = m_new;
      }
      // P as P.V's A fragment: k-index t is key 2t, t+4 is key 2t+1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = expf(s[nt][e] - mu[i]);
          rsum[i] += p;
          const int a = (e == 1) ? 2 : (e == 2) ? 1 : e;
          float h, mi, lo;
          split3f(p, h, mi, lo);
          phi[nt][a] = __float_as_uint(h);
          pmi[nt][a] = __float_as_uint(mi);
          plo[nt][a] = __float_as_uint(lo);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
    }
    __syncthreads();  // every warp is done with K(k0)
    if (k0 + BK < kend) load_keys<D, LQ>(k_s, k, b, Sk, Hk, hk, k0 + BK, vec);
    cp_commit();
    cp_wait<1>();  // V(k0) has landed
    __syncthreads();
    if (C::VREST)
      split_tile<BK * LV>(v_s, v_lo);
    else
      split_tile3<BK * LV>(v_s, v_mid, v_lo);
    __syncthreads();
    if (work) {
      // P.V with P and V in three parts each, the six terms down to
      // mid*mid (the dropped ones are below 2^-33 of the product); DG d
      // tiles at a time, each with a fresh accumulator for hi*hi and one
      // for the other five, added to O after the tile
#pragma unroll
      for (int d0 = 0; d0 < DK; d0 += DG) {
        float tb[DG][4], tx[DG][4];
#pragma unroll
        for (int j = 0; j < DG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tb[j][e] = tx[j][e] = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int vo = (nt * 8 + 2 * tq) * LV + d0 * 8 + gq;
#pragma unroll
          for (int j = 0; j < DG; ++j) {
            const uint32_t bh0 = __float_as_uint(v_s[vo + j * 8]);
            const uint32_t bh1 = __float_as_uint(v_s[vo + j * 8 + LV]);
            uint32_t bm0, bm1, bl0, bl1;
            if (C::VREST) {
              float m0, l0, m1, l1;
              splitf(v_lo[vo + j * 8], m0, l0);
              splitf(v_lo[vo + j * 8 + LV], m1, l1);
              bm0 = __float_as_uint(m0); bl0 = __float_as_uint(l0);
              bm1 = __float_as_uint(m1); bl1 = __float_as_uint(l1);
            } else {
              bm0 = __float_as_uint(v_mid[vo + j * 8]);
              bm1 = __float_as_uint(v_mid[vo + j * 8 + LV]);
              bl0 = __float_as_uint(v_lo[vo + j * 8]);
              bl1 = __float_as_uint(v_lo[vo + j * 8 + LV]);
            }
            mma(tx[j], plo[nt], bh0, bh1);
            mma(tx[j], phi[nt], bl0, bl1);
            mma(tx[j], pmi[nt], bm0, bm1);
            mma(tx[j], pmi[nt], bh0, bh1);
            mma(tx[j], phi[nt], bm0, bm1);
            mma(tb[j], phi[nt], bh0, bh1);
          }
        }
#pragma unroll
        for (int j = 0; j < DG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[d0 + j][e] =
                fmaf(oacc[d0 + j][e], alpha[e >> 1], tb[j][e] + tx[j][e]);
      }
    }
    __syncthreads();  // every warp is done with V(k0)
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (!live[i]) continue;
    const int r = warp * 16 + gq + 8 * i;
    // the row's log-sum-exp, in the scaled (and capped) logit domain, for
    // the backward (every live row sees at least its own key: m is finite)
    if (lse != nullptr && tq == 0)
      lse[((size_t)b * H + hk * G + r / BQ) * Sq + qpos[i]] = m[i] + logf(l[i]);
    float* orow =
        o + (((size_t)b * Sq + qpos[i]) * H + hk * G + r / BQ) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DK; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8) =
          make_float2(oacc[dt][2 * i] / l[i], oacc[dt][2 * i + 1] / l[i]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int Sq, int Sk, int H, int Hk, int causal,
           float cap, int window, cudaStream_t stream) {
  const int G = H / Hk;
  const int BQ = kRows / G;
  const size_t smem = Cfg<D>::smem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15u) == 0;
  const dim3 grid((Sq + BQ - 1) / BQ, Hk, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, H, Hk, G, BQ, causal, cap, window, scale,
      vec);
  return (int)cudaGetLastError();
}

// q/o (B, Sq, H, D), k/v (B, Sk, Hk, D) float32 contiguous; lse (B, H,
// Sq) float32, or null for no log-sum-exp.  cap <= 0 means no soft-cap,
// window <= 0 no sliding window; Sq != Sk takes neither a causal mask nor
// a window.
int flash_forward(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Sq, int Sk, int H, int Hk, int D,
                  int causal, float cap, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hk <= 0 || H % Hk || H / Hk > kRows ||
      B > 65535 || Hk > 65535 || (Sq != Sk && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  float* lf = (float*)lse;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, lf, B, Sq, Sk, H, Hk, causal, cap, window, st);
    case 32: return launch<32>(qf, kf, vf, of, lf, B, Sq, Sk, H, Hk, causal, cap, window, st);
    case 64: return launch<64>(qf, kf, vf, of, lf, B, Sq, Sk, H, Hk, causal, cap, window, st);
    case 96: return launch<96>(qf, kf, vf, of, lf, B, Sq, Sk, H, Hk, causal, cap, window, st);
    case 128: return launch<128>(qf, kf, vf, of, lf, B, Sq, Sk, H, Hk, causal, cap, window, st);
    case 256: return launch<256>(qf, kf, vf, of, lf, B, Sq, Sk, H, Hk, causal, cap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs and output (flash_attention_bf16), on Hopper's asynchronous
// machinery (hopper.cuh): the Pallas kernel's bf16 half.
//
// Arithmetic: Q.K^T in bf16 (the product of two bf16 values is exact in
// fp32, so S is the Pallas kernel's fp32 dot of its upcast tiles up to the
// order of the sums); the softmax in fp32; P enters P.V as two bf16 terms,
// its rounding hi and the rounding of the rest lo (bf16.cuh), V exact:
// within ~2^-17 of fp32's P.V, far below the output's one bf16 rounding; O
// and l in fp32, O / l rounded to bf16 once, at the store.
//
// Bound on an H100: a visible (query, key) pair takes 2 D operations for
// Q.K^T and 2 x 2 D for P.V's two terms, 6 D at the bf16 tensor cores'
// 989 TFLOP/s (PERF.md's bound counts the function's 4 D); 2 bytes an
// element of q, k, v and o.  At chatglm3-6b's causal prefill of 8192 (H
// 32, D 128) that is 0.83 ms of products against 0.07 ms of bytes: the
// products bound it, and only wgmma reaches that rate.  What the design
// does about it:
// - wgmma, two consumer warpgroups of 64 query rows each (a block's tile
//   of 128 rows: G heads x BQ = 128 / G positions that share the kv head,
//   row r = position q0 + r / G of head hk G + r % G, so K and V are read
//   once a tile).  S = Q.K^T is m64nBKk16 with Q and K K-major in shared
//   memory; P.V is m64nDPk16 with P's hi and lo terms from registers (S's
//   accumulator, packed pairwise, is P.V's A operand as it stands) and V
//   MN-major (the transpose bit), both terms into one fp32 O.
// - One producer warp issues every load with TMA from tensor maps over
//   the model layout (B, S, H, D), built on the host per launch: Q once,
//   K and V through a ring of STAGES stages of BK keys with full and empty
//   mbarriers; the boxes are 64 columns wide with the 128-byte swizzle
//   (D 16 and 32: one box of D columns, the 32- and 64-byte swizzles), so
//   the products read shared memory free of bank conflicts.  Rows past Sq
//   and keys past Sk are TMA's zero fill, masked in the softmax; nothing is
//   padded in device memory.  D 96 takes two boxes, the second's upper 32
//   columns zero-filled: Q.K^T skips their k steps and P.V runs N 128,
//   whose last 32 columns are not stored.
// - setmaxnreg gives the producer's warpgroup 24 registers a thread and the
//   consumers 240 (the 168 of the launch bounds before): O (DP / 2), S
//   (BK / 2) and P's two terms (BK / 2) stay in registers.  ptxas spills
//   only at D 96 and 128 (20 bytes, in the soft-capped path: tanhf's
//   temporaries beside 192 registers of S, P and O; the served LMs cap
//   only at D 256).
// - The softmax works on S's accumulator in registers, one row's max over
//   the four lanes of a quad: exp2 with the scale times log2 e folded into
//   one FFMA, masks only on a tile that reaches past Sk, the causal
//   diagonal or the window's lower edge (decided once a tile for the
//   block), the soft-cap on the accurate tanhf (tanh.approx's ~2^-11
//   would move a logit of 50 by ~0.02, several bf16 ulps of p).
// - Overlap: each consumer issues S(j) = Q.K(j)^T and then P(j-1).V(j-1),
//   and runs tile j's softmax (max, exponentials, row sums) while P.V is
//   still in flight; it then rescales O and packs P(j).  The two
//   warpgroups take turns to issue their products (ping-pong on two
//   named barriers), so one's softmax also runs under the other's
//   products (on an H100 SXM at 700 W: gemma2's S8192 prefill 6% faster,
//   chatglm3's and phi3's ~1%, and fewer spills).
// Q tiles run in reverse order (the longest causal rows first).  No
// atomics and no split over keys: one input gives one output, launch to
// launch.  A warpgroup whose rows are all past Sq or the tile only paces
// the ring.
// ---------------------------------------------------------------------------

using bf16mma::bf16;

constexpr int kRowsB = 128;                 // query rows a block
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreadsB = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kSmemBlock = 232448;          // the most a block may take
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct CfgB {
  static constexpr int BOXC = D < 64 ? D : 64;         // columns a box
  static constexpr int NBOX = (D + BOXC - 1) / BOXC;   // boxes a row
  static constexpr int DP = NBOX * BOXC;               // D 96: 128
  static constexpr int SPAN = 2 * BOXC;                // bytes a box row
  static constexpr int BK = D == 256 ? 64 : 128;       // keys a tile
  static constexpr int KSTEPS = D / 16;                // Q.K^T k steps
  static constexpr int PSTEPS = BK / 16;               // P.V k steps
  static constexpr int Q_BYTES = NBOX * kRowsB * SPAN;
  static constexpr int KV_BYTES = NBOX * BK * SPAN;    // K or V, a stage
  static constexpr int BARS = 1 + 3 * 4;               // Q, 3 a stage (<= 4)
  static constexpr int FREE = kSmemBlock - 1024 - 8 * BARS - Q_BYTES;
  static constexpr int STAGES =
      FREE / (2 * KV_BYTES) < 4 ? FREE / (2 * KV_BYTES) : 4;
  // 1024 bytes of slack to align the tiles, Q, the ring, the barriers
  static constexpr size_t smem =
      1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + 8 * (1 + 3 * STAGES);
  static_assert(STAGES >= 2, "flash_attention_bf16: two stages must fit");
  static_assert(smem <= kSmemBlock, "flash_attention_bf16: shared memory");
};

// 2^x (ex2.approx, relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float exp2f_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tile j's softmax on S (in place: p, fp32) and the row state: each
// thread's rows g and g + 8 (i = 0, 1) of its warp's 16.  t is the logit
// (the capped one with CAP, else the raw product, whose max is the scaled
// one's since scale > 0), c turns t into log2 units; masked keys are
// -inf.  alpha rescales O.
template <int N, bool MASK, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, float scap, float cap,
                                             int k0, int tq,
                                             const int (&qpos)[2], int Sk,
                                             int causal, int window) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int i = (e >> 1) & 1;
    float x = s[e];
    if (CAP) x = cap * tanhf(x * scap);
    if (MASK) {
      const int kpos = k0 + (e >> 2) * 8 + 2 * tq + (e & 1);
      const bool vis = kpos < Sk && (!causal || kpos <= qpos[i]) &&
                       (window <= 0 || kpos > qpos[i] - window);
      x = vis ? x : -INFINITY;
    }
    s[e] = x;
    tmax[i] = fmaxf(tmax[i], x);
  }
  float mc[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 1));
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 2));
    const float m_new = fmaxf(m[i], tmax[i]);
    const float mu = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen yet
    alpha[i] = exp2f_approx((m[i] - mu) * c);            // 0 before a key
    m[i] = m_new;
    mc[i] = mu * c;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int i = (e >> 1) & 1;
    s[e] = exp2f_approx(fmaf(s[e], c, -mc[i]));
    rsum[i] += s[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
}

template <int D>
__global__ void __launch_bounds__(kThreadsB, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Sk, int H, int G, int BQ, int causal,
                      float cap, int window, float scale) {
  using namespace hopper;
  using C = CfgB<D>;
  constexpr int BK = C::BK, ST = C::STAGES, SPAN = C::SPAN, NBOX = C::NBOX;
  constexpr int KV = C::KV_BYTES, SW = swizzle_code(SPAN);
  extern __shared__ unsigned char smem_raw[];
  // shared addresses: Q's NBOX boxes of 128 rows; the ring, stage s's K at
  // ring + 2 KV s and its V after it; the barriers
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_s + C::Q_BYTES;
  const uint32_t q_full = ring + ST * 2 * KV;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * ST,
                 empty = v_full + 8 * ST;   // + 8 s: stage s's

  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int R = G * BQ;
  // keys any row of this tile can see, in whole tiles from kbeg
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  kbeg -= kbeg % BK;
  const int ntiles = (kend - kbeg + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, (uint32_t)(NBOX * R * SPAN));
      for (int x = 0; x < NBOX; ++x)
        tma_load_4d(q_s + x * kRowsB * SPAN, &tq, q_full, x * C::BOXC,
                    hk * G, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % ST, use = t / ST;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        const int k0 = kbeg + t * BK;
        const uint32_t ks = ring + s * 2 * KV;
        mbar_expect_tx(k_full + 8 * s, (uint32_t)KV);
        for (int x = 0; x < NBOX; ++x)
          tma_load_4d(ks + x * BK * SPAN, &tk, k_full + 8 * s, x * C::BOXC,
                      hk, k0, b);
        mbar_expect_tx(v_full + 8 * s, (uint32_t)KV);
        for (int x = 0; x < NBOX; ++x)
          tma_load_4d(ks + KV + x * BK * SPAN, &tv, v_full + 8 * s,
                      x * C::BOXC, hk, k0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1;               // consumer 0 or 1
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int tq4 = lane % 4;
  // this thread's rows g and g + 8 of its warp's 16
  const int row0 = 64 * wg + 16 * warp + lane / 4;
  const int qpos[2] = {q0 + row0 / G, q0 + (row0 + 8) / G};
  // does any row of this warpgroup exist (its first has the lowest position)?
  const bool wg_live = 64 * wg < R && q0 + 64 * wg / G < Sq;
  const int qmax = min(q0 + BQ, Sq) - 1;
  // t in log2 units: the raw product's scale, or the capped logit's 1
  const float c = cap > 0.0f ? kLog2e : scale * kLog2e;
  const float scap = cap > 0.0f ? scale / cap : 0.0f;

  float oacc[C::DP / 2];
#pragma unroll
  for (int e = 0; e < C::DP / 2; ++e) oacc[e] = 0.0f;
  float s_acc[BK / 2];
  uint32_t phi[C::PSTEPS][4], plo[C::PSTEPS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];

  // descriptors of this warpgroup's 64 rows of Q and of stage 0's K
  // (K-major) and V (MN-major); a k step or a stage is an offset >> 4
  const uint64_t q_desc = descriptor(q_s + 64 * wg * SPAN, 16, 8 * SPAN, SW);
  const uint64_t k_desc = descriptor(ring, 16, 8 * SPAN, SW);
  const uint64_t v_desc = descriptor(ring + KV, BK * SPAN, 8 * SPAN, SW);
  auto qk = [&](int s) {  // S = Q.K(s)^T, committed
    const uint64_t dq = opaque(q_desc), dk = opaque(k_desc) + s * 2 * KV / 16;
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const int x = kk / (SPAN / 32), off = (kk % (SPAN / 32)) * 32;
      wgmma_ss<BK>(s_acc, dq + (x * kRowsB * SPAN + off) / 16,
                   dk + (x * BK * SPAN + off) / 16, kk > 0);
    }
    wgmma_commit();
  };
  auto pv = [&](int s) {  // O += P_lo.V(s) + P_hi.V(s), committed
    const uint64_t dv = opaque(v_desc) + s * 2 * KV / 16;
#pragma unroll
    for (int kk = 0; kk < C::PSTEPS; ++kk) {
      wgmma_rs<C::DP>(oacc, plo[kk], dv + kk * SPAN);  // 16 keys on
      wgmma_rs<C::DP>(oacc, phi[kk], dv + kk * SPAN);
    }
    wgmma_commit();
  };
  auto softmax = [&](int t) {
    const int k0 = kbeg + t * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= qmax - window);
    if (edge) {
      if (cap > 0.0f)
        softmax_tile<BK / 2, true, true>(s_acc, m, l, alpha, c, scap, cap, k0,
                                         tq4, qpos, Sk, causal, window);
      else
        softmax_tile<BK / 2, true, false>(s_acc, m, l, alpha, c, scap, cap,
                                          k0, tq4, qpos, Sk, causal, window);
    } else {
      if (cap > 0.0f)
        softmax_tile<BK / 2, false, true>(s_acc, m, l, alpha, c, scap, cap,
                                          k0, tq4, qpos, Sk, causal, window);
      else
        softmax_tile<BK / 2, false, false>(s_acc, m, l, alpha, c, scap, cap,
                                           k0, tq4, qpos, Sk, causal, window);
    }
  };
  auto pack_p = [&]() {  // P's A fragments: 16 keys a k step, hi and lo
#pragma unroll
    for (int kk = 0; kk < C::PSTEPS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        bf16mma::pack_split(s_acc[8 * kk + 2 * r], s_acc[8 * kk + 2 * r + 1],
                            phi[kk][r], plo[kk][r]);
  };
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(empty + 8 * s);
  };
  // ping-pong: where both warpgroups have rows, they take turns to issue
  // their products (named barrier 1 + w is warpgroup w's turn), so one's
  // softmax runs under the other's products; warpgroup 0 goes first
  const bool pingpong = R > 64 && q0 + 64 / G < Sq;
  auto turn_wait = [&]() {
    if (pingpong) asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    if (pingpong) asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
  };

  if (!wg_live) {
    // no row here: keep the ring's pace (each stage released once it has
    // landed, so no arrival runs ahead into the stage's next phase)
    for (int t = 0; t < ntiles; ++t) {
      mbar_wait(v_full + 8 * (t % ST), (t / ST) & 1);
      release(t % ST);
    }
    return;
  }

  if (pingpong && wg == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  turn_wait();
  wgmma_fence();
  qk(0);
  turn_pass();
  wgmma_wait<0>();
  fence_regs(s_acc);
  softmax(0);
  pack_p();
  for (int t = 1; t < ntiles; ++t) {
    const int s = t % ST, sp = (t - 1) % ST;
    mbar_wait(k_full + 8 * s, (t / ST) & 1);
    mbar_wait(v_full + 8 * sp, ((t - 1) / ST) & 1);
    turn_wait();
    wgmma_fence();
    qk(s);
    pv(sp);
    turn_pass();
    wgmma_wait<1>();        // S(t) has landed; P(t-1).V runs on
    fence_regs(s_acc);
    softmax(t);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(phi);
    fence_regs(plo);
    release(sp);
#pragma unroll
    for (int e = 0; e < C::DP / 2; ++e) oacc[e] *= alpha[(e >> 1) & 1];
    pack_p();
  }
  {
    const int sp = (ntiles - 1) % ST;
    mbar_wait(v_full + 8 * sp, ((ntiles - 1) / ST) & 1);
    wgmma_fence();
    pv(sp);
    wgmma_wait<0>();
    fence_regs(oacc);
    release(sp);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int r = row0 + 8 * i;
    if (r >= R || qpos[i] >= Sq) continue;
    // the training entry point's log-sum-exp of the scaled (capped) logits:
    // t c is a logit in log2 units, so lse = ln 2 (m c + log2 l)
    if (lse != nullptr && tq4 == 0)
      lse[((size_t)b * H + (size_t)hk * G + r % G) * Sq + qpos[i]] =
          (m[i] * c + log2f(l[i])) * 0.6931471805599453f;
    bf16* orow = o + (((size_t)b * Sq + qpos[i]) * H + (size_t)hk * G +
                      r % G) * D + 2 * tq4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = bf16mma::pack(
          oacc[4 * j + 2 * i] / l[i], oacc[4 * j + 2 * i + 1] / l[i]);
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (so the
// library links the runtime alone)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (B, S, heads, D) tensor as a rank-4 map (D, heads, S, B), boxes of
// (cols, box_heads, box_rows, 1) with the swizzle of `span` bytes; false
// where the driver refuses it
bool bf16_map(CUtensorMap* map, const void* p, int B, int S, int heads, int D,
              int cols, int box_heads, int box_rows, int span) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                float* lse, int B, int Sq, int Sk, int H, int Hk, int causal,
                float cap, int window, cudaStream_t stream) {
  using C = CfgB<D>;
  const int G = H / Hk;
  const int BQ = kRowsB / G;
  CUtensorMap tq, tk, tv;
  if (!bf16_map(&tq, q, B, Sq, H, D, C::BOXC, G, BQ, C::SPAN) ||
      !bf16_map(&tk, k, B, Sk, Hk, D, C::BOXC, 1, C::BK, C::SPAN) ||
      !bf16_map(&tv, v, B, Sk, Hk, D, C::BOXC, 1, C::BK, C::SPAN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hk, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_bf16_kernel<D><<<grid, kThreadsB, C::smem, stream>>>(
      tq, tk, tv, o, lse, Sq, Sk, H, G, BQ, causal, cap, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int config_bf16(int* out) {
  using C = CfgB<D>;
  const int v[] = {kRowsB, C::BK, C::STAGES, kConsumers, kThreadsB, C::NBOX,
                   C::BOXC, C::SPAN, (int)C::smem, kProducerRegs,
                   kConsumerRegs};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// The serving forward: no log-sum-exp.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int Hk, int D, int causal,
                                   float cap, int window, void* stream) {
  return flash_forward(q, k, v, o, nullptr, B, Sq, Sk, H, Hk, D, causal, cap,
                       window, stream);
}

namespace {

// bf16 q, k, v (B, Sq, H, D) / (B, Sk, Hk, D) into a bf16 o, fp32 inside
// (flash_fwd_bf16_kernel), and, where lse is not null, each row's
// log-sum-exp (fp32, (B, H, Sq)); q, k and v 16-byte aligned (TMA's rule),
// o 4-byte.
int flash_forward_bf16(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Sk, int H, int Hk,
                       int D, int causal, float cap, int window,
                       void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hk <= 0 || H % Hk || H / Hk > kRowsB ||
      B > 65535 || Hk > 65535 || (Sq != Sk && (causal || window > 0)) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15u) ||
      ((uintptr_t)o & 3u))
    return (int)cudaErrorInvalidValue;
  const bf16* qb = (const bf16*)q;
  const bf16* kb = (const bf16*)k;
  const bf16* vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BF16_CASE(DIM)                                               \
  case DIM:                                                                \
    return launch_bf16<DIM>(qb, kb, vb, ob, lse, B, Sq, Sk, H, Hk, causal, \
                            cap, window, st);
  switch (D) {
    FLASH_BF16_CASE(16)
    FLASH_BF16_CASE(32)
    FLASH_BF16_CASE(64)
    FLASH_BF16_CASE(96)
    FLASH_BF16_CASE(128)
    FLASH_BF16_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BF16_CASE
}

}  // namespace

// The serving forward on bf16 inputs: no log-sum-exp.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Sk, int H, int Hk, int D, int causal,
                                    float cap, int window, void* stream) {
  return flash_forward_bf16(q, k, v, o, nullptr, B, Sq, Sk, H, Hk, D, causal,
                            cap, window, stream);
}

// The bf16 training forward: o and each row's log-sum-exp, lse (B, H, Sq)
// fp32, which flash_attention_bwd_bf16 (flash_attention_bwd.cu) reads.  The
// same kernel as flash_attention_bf16's: o is its output bit for bit.
extern "C" int flash_attention_lse_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Sq, int Sk, int H, int Hk,
                                        int D, int causal, float cap,
                                        int window, void* stream) {
  return flash_forward_bf16(q, k, v, o, (float*)lse, B, Sq, Sk, H, Hk, D,
                            causal, cap, window, stream);
}

// The bf16 forward's figures at head dim D that kernel.py::fwd_bf16_plan
// mirrors: out[0..10] = query rows a block, keys a tile, stages, consumer
// warpgroups, threads, boxes a row, columns a box, swizzle bytes, shared
// memory bytes, the producer's and the consumers' registers a thread.
extern "C" int flash_attention_bf16_config(int D, int* out) {
  switch (D) {
    case 16: return config_bf16<16>(out);
    case 32: return config_bf16<32>(out);
    case 64: return config_bf16<64>(out);
    case 96: return config_bf16<96>(out);
    case 128: return config_bf16<128>(out);
    case 256: return config_bf16<256>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The training forward: o and each row's log-sum-exp, lse (B, H, Sq), which
// flash_attention_bwd_f32 (flash_attention_bwd.cu) reads.
extern "C" int flash_attention_lse_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Sk, int H, int Hk,
                                       int D, int causal, float cap,
                                       int window, void* stream) {
  return flash_forward(q, k, v, o, lse, B, Sq, Sk, H, Hk, D, causal, cap,
                       window, stream);
}
