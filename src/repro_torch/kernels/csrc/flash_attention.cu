// flash_attention.cu: forward GQA attention with an online softmax, fp32,
// causal or bidirectional, optional logit soft-cap and sliding window.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (Pallas body _flash_kernel).  The JAX stream MLLM
// computes the same function in plain jnp (models/attention.py,
// full_attention via attend_prefill); the port's MLLM and the served LMs'
// prefill call this kernel.
//
// Layout: the model's own, q/o (B, S, H, D) and k/v (B, S, Hk, D), all
// contiguous.  GQA puts G = H/Hk consecutive query heads on one kv head.
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
// of its rows sees; ragged edges (any S) are masked in the kernel, never
// padded: rows past S and keys past S load zeros and are masked out of
// the softmax.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// x = hi + lo exactly: hi is x rounded to 11 significant bits (a TF32
// value), by Veltkamp's split with 2^13 + 1 in fp32 arithmetic (no
// contraction: each step rounds); lo holds the other 13, of which the
// tensor cores read the top 10 (TF32 drops the low 13 bits of a register)
__device__ __forceinline__ void splitf(float x, float& hi, float& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  hi = __fsub_rn(c, __fsub_rn(c, x));
  lo = __fsub_rn(x, hi);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  splitf(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split2(float2 x, uint32_t& hi0, uint32_t& lo0,
                                       uint32_t& hi1, uint32_t& lo1) {
  split(x.x, hi0, lo0);
  split(x.y, hi1, lo1);
}

// one 16-byte (vec) or 4-byte copy into shared memory; zeros if !valid
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, bool vec) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// keys k0 .. k0+BK-1 of kv head hk into s (zeros past S)
template <int D, int LD>
__device__ __forceinline__ void load_keys(float* s, const float* src, int b,
                                          int S, int Hk, int hk, int k0,
                                          bool vec) {
  const int w = vec ? 4 : 1, per_row = D / w;
  for (int e = threadIdx.x; e < Cfg<D>::BK * per_row; e += kThreads) {
    const int j = e / per_row, c = (e % per_row) * w, pos = k0 + j;
    const bool ok = pos < S;
    cp_async(s + j * LD + c,
             ok ? src + (((size_t)b * S + pos) * Hk + hk) * D + c : src, ok,
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

// x = hi + mid + lo exactly, three TF32 values (lo holds x's last 2 bits)
__device__ __forceinline__ void split3f(float x, float& hi, float& mid,
                                       float& lo) {
  float r;
  splitf(x, hi, r);
  splitf(r, mid, lo);
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
                 const float* __restrict__ v, float* __restrict__ o, int S,
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
      const bool ok = r < R && pos < S;
      cp_async(q_s + r * LQ + c,
               ok ? q + (((size_t)b * S + pos) * H + hk * G + r / BQ) * D + c
                  : q,
               ok, vec);
    }
  }
  // keys any row of this tile can see
  const int kend = causal ? min(S, q0 + BQ) : S;
  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  kbeg -= kbeg % BK;
  load_keys<D, LQ>(k_s, k, b, S, Hk, hk, kbeg, vec);
  cp_commit();

  // this thread's two rows (fragment rows gq and gq+8 of the warp's 16)
  int qpos[2];
  bool live[2];
  int lo_pos = INT_MAX, hi_pos = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    qpos[i] = q0 + r % BQ;
    live[i] = r < R && qpos[i] < S;
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
    load_keys<D, LV>(v_s, v, b, S, Hk, hk, k0, vec);
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
          const bool vis = live[i] && kpos < S &&
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
    if (k0 + BK < kend) load_keys<D, LQ>(k_s, k, b, S, Hk, hk, k0 + BK, vec);
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
    float* orow =
        o + (((size_t)b * S + qpos[i]) * H + hk * G + r / BQ) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DK; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8) =
          make_float2(oacc[dt][2 * i] / l[i], oacc[dt][2 * i + 1] / l[i]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int Hk, int causal, float cap, int window,
           cudaStream_t stream) {
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
  const dim3 grid((S + BQ - 1) / BQ, Hk, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, S, H, Hk, G, BQ, causal, cap, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o (B, S, H, D), k/v (B, S, Hk, D) float32 contiguous.  cap <= 0 means
// no soft-cap, window <= 0 no sliding window.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hk, int D, int causal,
                                   float cap, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || H / Hk > kRows || B > 65535 ||
      Hk > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 32: return launch<32>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 64: return launch<64>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 96: return launch<96>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 128: return launch<128>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 256: return launch<256>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
