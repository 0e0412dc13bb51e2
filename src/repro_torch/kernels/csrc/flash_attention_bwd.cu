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
// The queries and keys may be of different lengths, Sq and Sk, where no
// positional mask applies (causal 0, no window: cross attention to an
// encoder's output): the dK/dV blocks tile the Sk keys and walk the Sq
// queries, the dQ blocks tile the Sq queries and walk the Sk keys, delta
// covers the Sq rows and the splits' scratch the Sk keys.  At Sq == Sk the
// code is the square kernel's.
//
// Bound on an H100: 10 D fp32 operations per visible (query, key) pair
// (Q.K^T recomputed, dO.V^T, dV, dK, dQ: five products of 2 D) and 4 bytes
// per element of q, k, v, o, dO, lse and dq, dk, dv, each read or written
// once.  At chatglm3-6b's micro-batch (B 8, S 64, H 32/2, D 128, causal:
// 0.53 M visible pairs) that is 0.68 GFLOP, 4.1 us at the tensor cores'
// 3xTF32 rate (165 fp32 TFLOP/s), against 35.7 MB, 10.7 us at 3.35 TB/s;
// at the stream MLLM's full frame (B 16, S 140, H 8/4, D 32: 1.26 M
// pairs) 0.40 GFLOP, 2.5 us, against 13.8 MB, 4.1 us: bytes bound both.
//
// What held the first kernel (fp32 FMA on the CUDA cores, a dK/dV block
// per (32 keys, kv head, row)) at 27-36x that bound: (1) too few dK/dV
// blocks where a group is large (32 for chatglm3's 132 SMs, each looping
// over 16 heads); (2) no tensor cores, and every FMA of its inner loops
// read shared memory; (3) no load in flight while a tile was computed.
// This one runs 11-21x the bound: a tile is a chain of loads, barriers,
// mma and the exp at 4 warps a scheduler, with no one part dominant
// (timed with each removed in turn, PERF.md); more work a warp between
// barriers needs registers the dK/dV sums hold at D 128.
//
// Design: three launches on the caller's stream, every sum in a fixed order
// (no atomics), so a launch repeats the last one bit for bit.
//  1. flash_bwd_delta: delta_i = dO_i.o_i, a few lanes a (row, head) with
//     16-byte loads, into a (B, H, Sq) scratch the wrapper allocates.
//  2. flash_bwd_main: the dK/dV blocks, then the dQ blocks, in one grid
//     (a dQ block starts as soon as the card has room, beside the dK/dV
//     blocks' tails).  A dK/dV block owns a tile of R = 32 keys (16 at D
//     256), a kv head, a split of the group's heads and a batch row.  The
//     host plan (kernels/flash_attention/kernel.py::bwd_plan) picks the
//     number of splits from the shape: the group's heads are cut into that
//     many consecutive runs (run sp holds heads sp G / splits .. (sp+1) G /
//     splits - 1), as long as the dK/dV blocks still fit the card at once
//     and the longest block's tiles plus the merge pass get fewer.  K and
//     V of the tile stay in shared memory; the block walks its heads and,
//     for each, the tiles of BC queries that can see a key of the tile
//     (from the tile's first key on when causal, up to its last key +
//     window - 1 under a window).  A block is 8 warps (6 at D 96): row
//     groups of 16 keys x WD warps over D (32 columns each, 16 at D 16) x
//     WQ column groups (the tile's queries shared out, 8 a warp).  A warp
//     computes the transposed scores S^T = K.Q^T and dP^T = V.dO^T (rows =
//     keys) over its columns of D and its 8 queries, the WD warps of a row
//     and column group add their parts through shared memory in warp
//     order, and P^T and dS^T then lie in accumulator fragments that are
//     the A operands of dV += P^T.dO and dK += dS^T.Q as they are (the
//     accumulator holds columns 2t and 2t+1 where the A fragment wants
//     k-indices t and t+4, so k-index t stands for query 2t and t+4 for
//     2t+1, and dO's and Q's B fragments are read from those rows), no trip
//     through shared memory.  The sums run in three levels, so that no
//     chain is long (one chain of G x S terms, 8320 at G 64, S 130, was 6x
//     farther from float64 than the plain version's autograd): a fresh sum
//     per query tile, added to its head's sum, added after each head to the
//     split's total, all in registers (2 x 32 columns a warp, so that two
//     blocks of 256 threads fit an SM's registers); after the last tile the
//     column groups' totals are added in group order through shared
//     memory.  With one split the total is dK (times the scale) and dV;
//     with more, each split's total goes to an fp32 scratch (2, splits, B,
//     Sk, Hk, D) that the wrapper allocates.  A dQ block owns a tile of R
//     queries of one head in the same warp layout (its column groups share
//     out the key tile), loops over the key tiles the forward visits for
//     those rows (flash_attention.cu's range), recomputes S = Q.K^T and dP
//     = dO.V^T the same way and sums dQ += dS.K in registers (a fresh sum
//     per key tile, added to the total; the column groups' totals added in
//     order at the end).
//  3. flash_bwd_merge (only with splits > 1): dK = scale sum_sp, dV =
//     sum_sp of the scratch, the splits added in split order.
// Every product runs on the tensor cores as mma.sync.m16n8k8 on split TF32
// operands (tf32.cuh): Q.K^T and dO.V^T 3xTF32 (hi*hi + hi*lo + lo*hi, as
// the forward's Q.K^T), hi*hi and the cross terms each in a fresh
// accumulator per two k steps added with fp32 adds (short chains of
// dependent mma); P^T.dO, dS^T.Q and dS.K in BWD_PDO_TERMS, BWD_DSQ_TERMS
// and BWD_DSK_TERMS terms (3 as above; 6: three-part operands down to
// mid*mid, as the forward's P.V), hi*hi and the other terms each in a fresh
// accumulator per tile, added to the sums with fp32 adds.  Three terms each
// pass the float64 gate of chip_smoke.py's phase 18 (a) (no farther from
// float64 than twice the plain version's autograd, plus 1e-6 of the
// largest gradient): unlike the forward's output behind a dominant key,
// every gradient element sums many products of both signs, whose fp32
// rounding exceeds 3xTF32's 2^-22 a product (scripts/flash_bwd_compare.py
// --variants builds and gates other counts).
// Streamed tiles (Q, dO, lse and delta in dK/dV; K and V in dQ) run
// through a ring of cp.async stages: two tiles in flight while one is
// computed up to D 64, one from D 96 (shared memory for two blocks an SM,
// and the faster of the two at D 128).  Once a tile lands, each thread
// splits the elements it copied in place (hi over the value, the exact
// rest beside it), before the one barrier of the tile, so the fragment
// loads read ready TF32 operands.  The resident rows (K, V in dK/dV; Q, dO
// in dQ) are split the same way once where D <= 64, and as they are read
// above that.  Every row is padded by 4 floats (a stride of 4 mod 32
// words), so both fragment patterns, (row g, column t) and (row 2t, column
// g), are free of bank conflicts.  Rows past Sq and keys past Sk load
// zeros and are masked (P = 0) and never stored; a warp skips the products of a tile
// none of its rows sees (but keeps the block's barriers).  Shared memory
// (Cfg<D>::smem) is at most 108,160 bytes (D 256: 16-key and 8-query
// tiles), two blocks an SM at every D; above 48 KB each launch raises the
// kernel's limit first.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32.cuh"

// The split terms of the three products whose A operand is a P or dS just
// computed: 3 (hi*hi, hi*lo, lo*hi) or 6 (three-part operands, down to
// mid*mid)
#ifndef BWD_PDO_TERMS
#define BWD_PDO_TERMS 3
#endif
#ifndef BWD_DSQ_TERMS
#define BWD_DSQ_TERMS 3
#endif
#ifndef BWD_DSK_TERMS
#define BWD_DSK_TERMS 3
#endif

namespace {

using namespace tf32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDeltaThreads = 256;
constexpr int kMergeThreads = 256;
constexpr int kSmemSM = 233472;  // shared memory of an H100 SM (228 KB)

template <int D>
struct Cfg {
  // warps over D in a row group, each taking DC = 32 columns (16 at D 16),
  // so that a warp's dK/dV sums are 2 DC registers and two blocks of 256
  // threads fit an SM's registers
  static constexpr int WD = D <= 32 ? 1 : D / 32;
  static constexpr int DC = D / WD;
  static constexpr int KS = DC / 8;  // 8-wide k steps over DC (even)
  static constexpr int DG = KS < 4 ? KS : 4;  // d tiles an output pass
  static constexpr int WR = D == 256 ? 1 : 2;  // 16-row groups
  static constexpr int R = 16 * WR;            // rows (keys, queries) a block
  // column groups: the streamed tile's columns are shared out over WQ
  // warps, each NTW 8-column tiles; their sums are added at the end
  static constexpr int WQ = D <= 32 ? 4 : (D == 64 ? 2 : 1);
  static constexpr int NTW = 1;
  static constexpr int BC = 8 * NTW * WQ;      // streamed rows a tile
  static constexpr int WARPS = WR * WD * WQ;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr bool XPRE = D <= 64;  // resident rows split once
  static constexpr int XP = XPRE ? 2 : 1;
  static constexpr int LD = D + 4;       // row stride (floats)
  // streamed tiles in flight: a ring of STAGES, the next loading while one
  // is computed, and a second up to D 64
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  // resident rows: 2 tensors x XP planes; streamed: STAGES x 2 tensors x
  // 2 planes (hi, rest), reused for the column groups' sums at the end;
  // the columns' lse and delta, STAGES; the score parts where WD > 1
  static constexpr int XF = 2 * XP * R * LD;
  static constexpr int YF = STAGES * 2 * 2 * BC * LD;
  static constexpr int SF = STAGES * 2 * BC;
  static constexpr int GS = 2 * NTW * 4 * 32;  // one warp's score parts
  static constexpr int CF = WD > 1 ? WARPS * GS : 0;
  static constexpr size_t smem = sizeof(float) * (size_t)(XF + YF + SF + CF);
  // blocks an SM holds by shared memory; the launch bounds ask for two
  // where they fit (registers: 65536 / (2 THREADS) a thread)
  static constexpr int FIT = (int)(kSmemSM / (smem + 1024));
  static constexpr int MINB = FIT >= 2 ? 2 : 1;
  static_assert(WARPS * 2 * KS * 4 * 32 <= YF, "column sums overlay tiles");
};

// rows p0 .. p0+n-1 of head h of a (B, S, NH, D) tensor into dst (row
// stride D+4) with cp.async; zeros past S (Sq for q and dO, Sk for k and
// v)
template <int D, int THREADS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int S, int NH, int h, int p0,
                                          int n, bool vec) {
  constexpr int LD = D + 4;
  const int w = vec ? 4 : 1, per_row = D / w;
  for (int e = threadIdx.x; e < n * per_row; e += THREADS) {
    const int r = e / per_row, c = (e % per_row) * w, pos = p0 + r;
    const bool ok = pos < S;
    cp_async(dst + r * LD + c,
             ok ? src + (((size_t)b * S + pos) * NH + h) * D + c : src, ok,
             vec);
  }
}

// the elements this thread copied with load_rows, once landed, split in
// place: hi over the value, the exact rest into lo (read by the tensor
// cores as its TF32 part)
template <int D, int THREADS>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int n,
                                           bool vec) {
  constexpr int LD = D + 4;
  const int w = vec ? 4 : 1, per_row = D / w;
  for (int e = threadIdx.x; e < n * per_row; e += THREADS) {
    const int at = (e / per_row) * LD + (e % per_row) * w;
    if (vec) {
      const float4 x = *reinterpret_cast<const float4*>(hi + at);
      float4 h, l;
      splitf(x.x, h.x, l.x);
      splitf(x.y, h.y, l.y);
      splitf(x.z, h.z, l.z);
      splitf(x.w, h.w, l.w);
      *reinterpret_cast<float4*>(hi + at) = h;
      *reinterpret_cast<float4*>(lo + at) = l;
    } else {
      float h, l;
      splitf(hi[at], h, l);
      hi[at] = h;
      lo[at] = l;
    }
  }
}

// out[nt] = X . Y^T over this warp's DC columns: 16 rows of X (offset xo
// of row g, column dc0 + t) against 8 rows of Y a column tile (planes yh,
// yl; offset yo of row g, column dc0 + t), 3xTF32.  For each two k steps,
// hi*hi in one fresh accumulator and the cross terms in another, added to
// out and to the cross terms' sum with fp32 adds (short chains of
// dependent mma); the cross terms are added last.  X is read from its
// planes xh/xl where it was split once (XPRE), else split as it is read
// from xh.
template <class C>
__device__ __forceinline__ void scores(const float* xh, const float* xl,
                                       const float* yh, const float* yl,
                                       int xo, int yo,
                                       float (&out)[C::NTW][4]) {
  constexpr int LD = C::LD, NT = C::NTW, KS = C::KS;
  float cr[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = cr[nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = xo + (kk + h) * 8;
      const int at[4] = {o, o + 8 * LD, o + 4, o + 8 * LD + 4};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (C::XPRE) {
          ah[h][i] = __float_as_uint(xh[at[i]]);
          al[h][i] = __float_as_uint(xl[at[i]]);
        } else {
          split(xh[at[i]], ah[h][i], al[h][i]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = yo + nt * 8 * LD + (kk + h) * 8;
        const uint32_t bh0 = __float_as_uint(yh[o]);
        const uint32_t bh1 = __float_as_uint(yh[o + 4]);
        const uint32_t bl0 = __float_as_uint(yl[o]);
        const uint32_t bl1 = __float_as_uint(yl[o + 4]);
        mma(x, al[h], bh0, bh1);
        mma(x, ah[h], bl0, bl1);
        mma(t, ah[h], bh0, bh1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[nt][e] += t[e];
        cr[nt][e] += x[e];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] += cr[nt][e];
}

// The WD warps that share a row group and a column group add their score
// parts in warp order (through shared memory, one block barrier), so that
// each holds the scores over all of D.  Called by every thread; warps
// that skip the tile (work false, the same for all WD) write and read
// nothing.  grp: the first warp of the WD (its index over the block).
template <class C>
__device__ __forceinline__ void gather_parts(float* xc, int grp, int dg,
                                             bool work,
                                             float (&sc)[C::NTW][4],
                                             float (&dp)[C::NTW][4]) {
  if constexpr (C::WD > 1) {
    constexpr int NT = C::NTW;
    const int lane = threadIdx.x & 31;
    float* base = xc + grp * C::GS;
    if (work) {
      float* mine = base + dg * C::GS;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(nt * 4 + e) * 32 + lane] = sc[nt][e];
          mine[(NT * 4 + nt * 4 + e) * 32 + lane] = dp[nt][e];
        }
    }
    __syncthreads();
    if (work) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int js = (nt * 4 + e) * 32 + lane;
          const int jp = (NT * 4 + nt * 4 + e) * 32 + lane;
          float a = base[js], c = base[jp];
#pragma unroll
          for (int g = 1; g < C::WD; ++g) {
            a += base[g * C::GS + js];
            c += base[g * C::GS + jp];
          }
          sc[nt][e] = a;
          dp[nt][e] = c;
        }
    }
  }
}

template <int TERMS>
struct Parts {
  static constexpr int N = TERMS == 6 ? 3 : 2;
};

// accumulator fragments x (16 rows x 8 NT columns) as the A operand of the
// next product: k-index t of each 8-column tile is column 2t, t+4 is
// column 2t+1; split in two parts (hi, rest) or three (hi, mid, lo)
template <int TERMS, int NT>
__device__ __forceinline__ void a_parts(const float (&x)[NT][4],
                                        uint32_t (&a)[Parts<TERMS>::N][NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (e == 1) ? 2 : (e == 2) ? 1 : e;
      if constexpr (TERMS == 6) {
        float h, m, l;
        split3f(x[nt][e], h, m, l);
        a[0][nt][i] = __float_as_uint(h);
        a[1][nt][i] = __float_as_uint(m);
        a[2][nt][i] = __float_as_uint(l);
      } else {
        split(x[nt][e], a[0][nt][i], a[1][nt][i]);
      }
    }
}

// acc[dt] += A . Y over this warp's DC columns: A (16 x 8 NTW, its parts in
// A-fragment order) against the warp's 8 NTW rows of the tile's Y (planes
// yh, yl; offset yo of row 2t, column dc0 + g).  For DG d tiles at a time,
// hi*hi in a fresh accumulator and the other terms in another, then acc +=
// tb + tx (fp32 adds).  Six terms take Y's rest apart into mid and lo as
// it is read.
template <class C, int TERMS>
__device__ __forceinline__ void accumulate(
    float (&acc)[C::KS][4], const uint32_t (&a)[Parts<TERMS>::N][C::NTW][4],
    const float* yh, const float* yl, int yo) {
  constexpr int LD = C::LD, NT = C::NTW, KS = C::KS, DG = C::DG;
#pragma unroll
  for (int d0 = 0; d0 < KS; d0 += DG) {
    float tb[DG][4], tx[DG][4];
#pragma unroll
    for (int j = 0; j < DG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tb[j][e] = tx[j][e] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = yo + nt * 8 * LD + d0 * 8;
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        const uint32_t bh0 = __float_as_uint(yh[o + j * 8]);
        const uint32_t bh1 = __float_as_uint(yh[o + j * 8 + LD]);
        const float r0 = yl[o + j * 8], r1 = yl[o + j * 8 + LD];
        if constexpr (TERMS == 6) {
          float m0, l0, m1, l1;
          splitf(r0, m0, l0);
          splitf(r1, m1, l1);
          const uint32_t bm0 = __float_as_uint(m0), bm1 = __float_as_uint(m1);
          const uint32_t bl0 = __float_as_uint(l0), bl1 = __float_as_uint(l1);
          mma(tx[j], a[2][nt], bh0, bh1);
          mma(tx[j], a[0][nt], bl0, bl1);
          mma(tx[j], a[1][nt], bm0, bm1);
          mma(tx[j], a[1][nt], bh0, bh1);
          mma(tx[j], a[0][nt], bm0, bm1);
        } else {
          mma(tx[j], a[1][nt], bh0, bh1);
          mma(tx[j], a[0][nt], __float_as_uint(r0), __float_as_uint(r1));
        }
        mma(tb[j], a[0][nt], bh0, bh1);
      }
    }
#pragma unroll
    for (int j = 0; j < DG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + j][e] += tb[j][e] + tx[j][e];
  }
}

// The column groups' sums are added in group order: after the tile loop
// (red overlays the streamed tiles), groups 1 .. WQ-1 put each of their N
// sums in their own slots of red (put_sums), and group 0 adds them to its
// own (add_sums), with a block barrier between.
template <class C, int N>
__device__ __forceinline__ void put_sums(float* red, int warp, int n,
                                         const float (&arr)[C::KS][4]) {
  const int lane = threadIdx.x & 31;
  float* mine = red + (warp * N + n) * C::KS * 4 * 32;
#pragma unroll
  for (int dt = 0; dt < C::KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(dt * 4 + e) * 32 + lane] = arr[dt][e];
}

template <class C, int N>
__device__ __forceinline__ void add_sums(const float* red, int warp, int n,
                                         float (&arr)[C::KS][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 1; c < C::WQ; ++c) {
    // the same row group and columns of D in column group c
    const float* other = red + ((warp + c * C::WD) * N + n) * C::KS * 4 * 32;
#pragma unroll
    for (int dt = 0; dt < C::KS; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) arr[dt][e] += other[(dt * 4 + e) * 32 + lane];
  }
}

// the capped (or plain) scaled logit, P and dS (the gradient of the raw
// score s, before the scale) of one visible or masked pair
__device__ __forceinline__ void grad_pair(float s, float dpv, float lse,
                                          float dl, bool vis, float cap,
                                          float scale, float& p, float& ds) {
  float x = s * scale;
  if (cap > 0.0f) x = cap * tanhf(x / cap);
  p = vis ? expf(x - lse) : 0.0f;
  ds = p * (dpv - dl);
  if (cap > 0.0f) {
    const float t = x / cap;
    ds *= 1.0f - t * t;
  }
}

// a row's 16-byte chunk c as fp32: four floats (scalar loads where !vec)
// or eight bf16 values
__device__ __forceinline__ void chunk(const float* row, int c, bool vec,
                                      float (&x)[4]) {
  const float4 a = vec ? __ldg(reinterpret_cast<const float4*>(row) + c)
                       : make_float4(row[4 * c], row[4 * c + 1],
                                     row[4 * c + 2], row[4 * c + 3]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

__device__ __forceinline__ void chunk(const bf16mma::bf16* row, int c, bool,
                                      float (&x)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(row) + c);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// flash_bwd_delta's shape: E elements a chunk, CH chunks a row, TPR lanes a
// row (a power of two, so a row's lanes are one aligned group of a warp's),
// ROWS rows a block
template <class T, int D>
struct DeltaRows {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int CH = D / E;
  static constexpr int TPR = CH >= 32 ? 32 : CH >= 16 ? 16 : CH >= 8 ? 8
                             : CH >= 4 ? 4 : 2;
  static constexpr int ROWS = kDeltaThreads / TPR;
};

// delta_i = dO_i.o_i of the (B, Sq, H, D) layout's (position, head) rows,
// fp32 or bf16, TPR lanes a row a chunk at a time (16-byte loads where vec;
// bf16 rows always), fp32 sums, into delta (B, H, Sq)
template <class T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int S, int H,
                bool vec) {
  using R = DeltaRows<T, D>;
  const long long row =
      (long long)blockIdx.x * R::ROWS + threadIdx.x / R::TPR;
  const int sub = threadIdx.x % R::TPR;
  float acc = 0.0f;
  if (row < rows) {
    for (int c = sub; c < R::CH; c += R::TPR) {
      float x[R::E], y[R::E];
      chunk(o + row * D, c, vec, x);
      chunk(dout + row * D, c, vec, y);
#pragma unroll
      for (int e = 0; e < R::E; ++e) acc = fmaf(y[e], x[e], acc);
    }
  }
#pragma unroll
  for (int off = R::TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (row < rows && sub == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % S), b = (int)(bs / S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// the problem a launch solves, as flash_bwd_main's blocks read it
struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv, *part;
  int B, Sq, Sk, H, Hk, G, splits, causal, window;
  float cap, scale;
  bool vec;
};

// dK and dV of key tile kt, split sp, kv head hk, batch row b
template <int D>
__device__ __forceinline__ void dkdv_block(const Args& A, float* smem, int kt,
                                           int sp, int hk, int b) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, R = C::R, BC = C::BC, NT = C::NTW, KS = C::KS,
                XP = C::XP, TH = C::THREADS, NS = C::STAGES;
  const float* __restrict__ q = A.q;
  const float* __restrict__ k = A.k;
  const float* __restrict__ v = A.v;
  const float* __restrict__ dout = A.dout;
  const float* __restrict__ lse = A.lse;
  const float* __restrict__ delta = A.delta;
  const int Sq = A.Sq, Sk = A.Sk, H = A.H, Hk = A.Hk, G = A.G,
            splits = A.splits;
  const int causal = A.causal, window = A.window;
  const float cap = A.cap, scale = A.scale;
  const bool vec = A.vec;
  float* x_s = smem;            // [K, V][XP][R][LD]
  float* y_s = x_s + C::XF;     // [stage][Q, dO][hi, rest][BC][LD]
  float* st_s = y_s + C::YF;    // [stage][lse, delta][BC]
  float* xc = st_s + C::SF;     // the score parts

  const int k0 = kt * R;
  const int g0 = sp * G / splits, g1 = (sp + 1) * G / splits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, column group
  const int dg = warp % C::WD, cg = (warp / C::WD) % C::WQ;
  const int rg = warp / (C::WD * C::WQ);
  const int dc0 = dg * C::DC, c0 = cg * NT * 8;
  const int kw = k0 + rg * 16;  // the warp's first key

  // the queries that can see a key of the tile
  const int klast = min(Sk, k0 + R) - 1;
  const int qbeg = causal ? k0 : 0;
  const int qend = window > 0 ? min(Sq, klast + window) : Sq;
  const int nq = (qend - qbeg + BC - 1) / BC;
  const int T = (g1 - g0) * nq;  // tiles: the split's heads x query tiles

  auto load_y = [&](int stage, int h, int q0) {
    float* base = y_s + stage * 4 * BC * LD;
    load_rows<D, TH>(base, q, b, Sq, H, h, q0, BC, vec);
    load_rows<D, TH>(base + 2 * BC * LD, dout, b, Sq, H, h, q0, BC, vec);
    if (threadIdx.x < 2 * BC) {
      const int pos = q0 + threadIdx.x % BC;
      const float* src = threadIdx.x < BC ? lse : delta;
      const bool ok = pos < Sq;
      cp_async(st_s + stage * 2 * BC + threadIdx.x,
               ok ? src + ((size_t)b * H + h) * Sq + pos : src, ok, false);
    }
  };
  // the ring: tile j in stage j % NS; groups 0 .. NS-2 hold K and V and
  // the first NS-1 tiles, then one group a tile (empty past the last)
  load_rows<D, TH>(x_s, k, b, Sk, Hk, hk, k0, R, vec);
  load_rows<D, TH>(x_s + XP * R * LD, v, b, Sk, Hk, hk, k0, R, vec);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < T) load_y(j, hk * G + g0 + j / nq, qbeg + (j % nq) * BC);
    cp_commit();
  }

  // dK's and dV's sums: the head's (hs_*) and the split's (tot_*), each a
  // 16 x DC tile of accumulator fragments (row g + 8 (e >> 1), column
  // dc0 + 8 dt + 2t + (e & 1))
  float hs_k[KS][4], hs_v[KS][4], tot_k[KS][4], tot_v[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hs_k[dt][e] = hs_v[dt][e] = tot_k[dt][e] = tot_v[dt][e] = 0.0f;

  const float* kx = x_s + rg * 16 * LD;  // the warp's K rows, then V's
  const float* vx = kx + XP * R * LD;
  const int xo = gq * LD + dc0 + tq;
  const int yo = (c0 + gq) * LD + dc0 + tq;
  const int yo2 = (c0 + 2 * tq) * LD + dc0 + gq;

  for (int t = 0; t < T; ++t) {
    const int st = t % NS, q0 = qbeg + (t % nq) * BC;
    float* qh = y_s + st * 4 * BC * LD;
    float* ql = qh + BC * LD;
    float* oh = ql + BC * LD;
    float* ol = oh + BC * LD;
    const float* lse_c = st_s + st * 2 * BC + c0;
    const float* dl_c = lse_c + BC;
    cp_wait<NS - 2>();  // this thread's copies of tile t (first: K and V)
    if constexpr (C::XPRE) {
      if (t == 0) {
        split_rows<D, TH>(x_s, x_s + R * LD, R, vec);
        split_rows<D, TH>(x_s + 2 * R * LD, x_s + 3 * R * LD, R, vec);
      }
    }
    split_rows<D, TH>(qh, ql, BC, vec);
    split_rows<D, TH>(oh, ol, BC, vec);
    __syncthreads();  // tile t is split; every warp is done with tile t-1
    {
      const int tn = t + NS - 1;  // into the stage tile t-1 held
      if (tn < T) load_y(tn % NS, hk * G + g0 + tn / nq, qbeg + (tn % nq) * BC);
      cp_commit();
    }
    // does any key of this warp see one of its queries of the tile?
    const int qlo = q0 + c0, qhi = min(qlo + NT * 8, Sq) - 1;
    const bool work = kw < Sk && qlo < Sq && (!causal || kw <= qhi) &&
                      (window <= 0 || min(kw + 15, Sk - 1) > qlo - window);
    float sc[NT][4], dp[NT][4];
    if (work) {
      scores<C>(kx, kx + R * LD, qh, ql, xo, yo, sc);
      scores<C>(vx, vx + R * LD, oh, ol, xo, yo, dp);
    }
    gather_parts<C>(xc, warp - dg, dg, work, sc, dp);
    if (work) {
      float pt[NT][4], dst[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + gq + 8 * (e >> 1);
          const int jc = nt * 8 + 2 * tq + (e & 1), qpos = qlo + jc;
          const bool vis = key < Sk && qpos < Sq &&
                           (!causal || key <= qpos) &&
                           (window <= 0 || key > qpos - window);
          grad_pair(sc[nt][e], dp[nt][e], lse_c[jc], dl_c[jc], vis, cap,
                    scale, pt[nt][e], dst[nt][e]);
        }
      {
        uint32_t a[Parts<BWD_PDO_TERMS>::N][NT][4];
        a_parts<BWD_PDO_TERMS, NT>(pt, a);
        accumulate<C, BWD_PDO_TERMS>(hs_v, a, oh, ol, yo2);
      }
      {
        uint32_t a[Parts<BWD_DSQ_TERMS>::N][NT][4];
        a_parts<BWD_DSQ_TERMS, NT>(dst, a);
        accumulate<C, BWD_DSQ_TERMS>(hs_k, a, qh, ql, yo2);
      }
    }
    if (t % nq == nq - 1) {  // the head's last tile
#pragma unroll
      for (int dt = 0; dt < KS; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot_k[dt][e] += hs_k[dt][e];
          tot_v[dt][e] += hs_v[dt][e];
          hs_k[dt][e] = hs_v[dt][e] = 0.0f;
        }
    }
  }
  cp_wait<0>();
  if constexpr (C::WQ > 1) {
    __syncthreads();  // every warp is done with the streamed tiles
    if (cg > 0) {
      put_sums<C, 2>(y_s, warp, 0, tot_k);
      put_sums<C, 2>(y_s, warp, 1, tot_v);
    }
    __syncthreads();
    if (cg > 0) return;
    add_sums<C, 2>(y_s, warp, 0, tot_k);
    add_sums<C, 2>(y_s, warp, 1, tot_v);
  }

  const size_t n = (size_t)A.B * Sk * Hk * D;  // one split's elements
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + gq + 8 * i;
    if (key >= Sk) continue;
    const size_t row = (((size_t)b * Sk + key) * Hk + hk) * D;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      const int d = dc0 + dt * 8 + 2 * tq;
      const float2 tk = make_float2(tot_k[dt][2 * i], tot_k[dt][2 * i + 1]);
      const float2 tv = make_float2(tot_v[dt][2 * i], tot_v[dt][2 * i + 1]);
      if (splits == 1) {
        *reinterpret_cast<float2*>(A.dk + row + d) =
            make_float2(tk.x * scale, tk.y * scale);
        *reinterpret_cast<float2*>(A.dv + row + d) = tv;
      } else {
        *reinterpret_cast<float2*>(A.part + sp * n + row + d) = tk;
        *reinterpret_cast<float2*>(A.part + (splits + sp) * n + row + d) =
            tv;
      }
    }
  }
}

// four sums into element group i of dst: fp32 as they are, bf16 rounded
__device__ __forceinline__ void store4(float* dst, long long i, float a,
                                       float b, float c, float d) {
  reinterpret_cast<float4*>(dst)[i] = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(bf16mma::bf16* dst, long long i,
                                       float a, float b, float c, float d) {
  reinterpret_cast<uint2*>(dst)[i] =
      make_uint2(bf16mma::pack(a, b), bf16mma::pack(c, d));
}

// dK = scale x the splits' dK totals, dV = their dV totals, added in split
// order (fp32 scratch) and stored once as T, four elements a thread
template <class T>
__global__ void __launch_bounds__(kMergeThreads)
flash_bwd_merge(const float* __restrict__ part, T* __restrict__ dk,
                T* __restrict__ dv, long long n4, int splits, float scale) {
  const long long i = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n4) return;
  const float4* pk = reinterpret_cast<const float4*>(part) + i;
  const float4* pv = pk + (long long)splits * n4;
  float4 a = pk[0], c = pv[0];
  for (int s = 1; s < splits; ++s) {
    const float4 x = pk[s * n4], y = pv[s * n4];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
    c.x += y.x;
    c.y += y.y;
    c.z += y.z;
    c.w += y.w;
  }
  store4(dk, i, a.x * scale, a.y * scale, a.z * scale, a.w * scale);
  store4(dv, i, c.x, c.y, c.z, c.w);
}

// dQ of the query tile at q0, query head h, batch row b
template <int D>
__device__ __forceinline__ void dq_block(const Args& A, float* smem, int q0,
                                         int h, int b) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, R = C::R, BC = C::BC, NT = C::NTW, KS = C::KS,
                XP = C::XP, TH = C::THREADS, NS = C::STAGES;
  const float* __restrict__ q = A.q;
  const float* __restrict__ k = A.k;
  const float* __restrict__ v = A.v;
  const float* __restrict__ dout = A.dout;
  const int Sq = A.Sq, Sk = A.Sk, H = A.H, Hk = A.Hk, G = A.G;
  const int causal = A.causal, window = A.window;
  const float cap = A.cap, scale = A.scale;
  const bool vec = A.vec;
  float* x_s = smem;                  // [Q, dO][XP][R][LD]
  float* y_s = x_s + C::XF;           // [stage][K, V][hi, rest][BC][LD]
  float* xc = y_s + C::YF + C::SF;    // the score parts
  const int hk = h / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int dg = warp % C::WD, cg = (warp / C::WD) % C::WQ;
  const int rg = warp / (C::WD * C::WQ);
  const int dc0 = dg * C::DC, c0 = cg * NT * 8;
  const int qw = q0 + rg * 16;  // the warp's first query

  // the keys any row of the tile sees (flash_attention.cu's range)
  const int kend = causal ? min(Sk, q0 + R) : Sk;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int T = (kend - kbeg + BC - 1) / BC;

  auto load_y = [&](int stage, int kk0) {
    float* base = y_s + stage * 4 * BC * LD;
    load_rows<D, TH>(base, k, b, Sk, Hk, hk, kk0, BC, vec);
    load_rows<D, TH>(base + 2 * BC * LD, v, b, Sk, Hk, hk, kk0, BC, vec);
  };
  load_rows<D, TH>(x_s, q, b, Sq, H, h, q0, R, vec);
  load_rows<D, TH>(x_s + XP * R * LD, dout, b, Sq, H, h, q0, R, vec);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < T) load_y(j, kbeg + j * BC);
    cp_commit();
  }

  // this thread's two rows' lse and delta (0 past Sq)
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = qw + gq + 8 * i;
    const size_t at = ((size_t)b * H + h) * Sq + pos;
    lr[i] = pos < Sq ? __ldg(A.lse + at) : 0.0f;
    dr[i] = pos < Sq ? __ldg(A.delta + at) : 0.0f;
  }

  float acc[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  const float* qx = x_s + rg * 16 * LD;  // the warp's Q rows, then dO's
  const float* ox = qx + XP * R * LD;
  const int xo = gq * LD + dc0 + tq;
  const int yo = (c0 + gq) * LD + dc0 + tq;
  const int yo2 = (c0 + 2 * tq) * LD + dc0 + gq;

  for (int t = 0; t < T; ++t) {
    const int st = t % NS, k0 = kbeg + t * BC;
    float* kh = y_s + st * 4 * BC * LD;
    float* kl = kh + BC * LD;
    float* vh = kl + BC * LD;
    float* vl = vh + BC * LD;
    cp_wait<NS - 2>();  // this thread's copies of tile t (first: Q and dO)
    if constexpr (C::XPRE) {
      if (t == 0) {
        split_rows<D, TH>(x_s, x_s + R * LD, R, vec);
        split_rows<D, TH>(x_s + 2 * R * LD, x_s + 3 * R * LD, R, vec);
      }
    }
    split_rows<D, TH>(kh, kl, BC, vec);
    split_rows<D, TH>(vh, vl, BC, vec);
    __syncthreads();  // tile t is split; every warp is done with tile t-1
    {
      const int tn = t + NS - 1;  // into the stage tile t-1 held
      if (tn < T) load_y(tn % NS, kbeg + tn * BC);
      cp_commit();
    }
    // does any row of this warp see one of its keys of the tile?
    const int klo = k0 + c0, khi = min(klo + NT * 8, Sk) - 1;
    const int qmax = min(qw + 15, Sq - 1);
    const bool work = qw < Sq && klo < Sk && (!causal || klo <= qmax) &&
                      (window <= 0 || khi > qw - window);
    float sc[NT][4], dp[NT][4];
    if (work) {
      scores<C>(qx, qx + R * LD, kh, kl, xo, yo, sc);
      scores<C>(ox, ox + R * LD, vh, vl, xo, yo, dp);
    }
    gather_parts<C>(xc, warp - dg, dg, work, sc, dp);
    if (work) {
      float pr[NT][4], dsr[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, qpos = qw + gq + 8 * i;
          const int key = klo + nt * 8 + 2 * tq + (e & 1);
          const bool vis = qpos < Sq && key < Sk &&
                           (!causal || key <= qpos) &&
                           (window <= 0 || key > qpos - window);
          grad_pair(sc[nt][e], dp[nt][e], lr[i], dr[i], vis, cap, scale,
                    pr[nt][e], dsr[nt][e]);
        }
      uint32_t a[Parts<BWD_DSK_TERMS>::N][NT][4];
      a_parts<BWD_DSK_TERMS, NT>(dsr, a);
      accumulate<C, BWD_DSK_TERMS>(acc, a, kh, kl, yo2);
    }
  }
  cp_wait<0>();
  if constexpr (C::WQ > 1) {
    __syncthreads();  // every warp is done with the streamed tiles
    if (cg > 0) put_sums<C, 1>(y_s, warp, 0, acc);
    __syncthreads();
    if (cg > 0) return;
    add_sums<C, 1>(y_s, warp, 0, acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = qw + gq + 8 * i;
    if (pos >= Sq) continue;
    float* row = A.dq + (((size_t)b * Sq + pos) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
      *reinterpret_cast<float2*>(row + dc0 + dt * 8 + 2 * tq) =
          make_float2(acc[dt][2 * i] * scale, acc[dt][2 * i + 1] * scale);
  }
}

// One launch of both kinds of block: first the dK/dV blocks (key tile
// fastest, then split, kv head, batch row: the longest causal tiles start
// first), then the dQ blocks (query tiles in reverse order, then head,
// batch row).  They share nothing but the launch: a dQ block runs as soon
// as the card has room, beside the dK/dV blocks' tails.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MINB)
flash_bwd_main(const Args A, long long n_dkdv) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = Cfg<D>::R;
  long long i = blockIdx.x;
  if (i < n_dkdv) {
    const int nt = (A.Sk + R - 1) / R;  // key tiles
    const int x = (int)(i % ((long long)nt * A.splits));
    i /= (long long)nt * A.splits;
    dkdv_block<D>(A, smem, x % nt, x / nt, (int)(i % A.Hk),
                  (int)(i / A.Hk));
  } else {
    const int nt = (A.Sq + R - 1) / R;  // query tiles
    i -= n_dkdv;
    const int x = (int)(i % nt);
    i /= nt;
    dq_block<D>(A, smem, (nt - 1 - x) * R, (int)(i % A.H), (int)(i / A.H));
  }
}

template <int D>
int config(int* out) {
  using C = Cfg<D>;
  out[0] = C::R;
  out[1] = C::BC;
  out[2] = (int)C::smem;
  out[3] = C::MINB;
  return 0;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* part,
           float* dq, float* dk, float* dv, int B, int Sq, int Sk, int H,
           int Hk, int causal, float cap, int window, int splits,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const int G = H / Hk;
  const int nkt = (Sk + C::R - 1) / C::R, nqt = (Sq + C::R - 1) / C::R;
  if (splits < 1 || splits > G || (splits > 1 && part == nullptr) ||
      ((long long)nkt * splits * Hk + (long long)nqt * H) * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (C::smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_main<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) & 15u) == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long rows_bsh = (long long)B * Sq * H;
  constexpr int kRowsDelta = DeltaRows<float, D>::ROWS;
  const bool vec_o = (((uintptr_t)o | (uintptr_t)dout) & 15u) == 0;
  flash_bwd_delta<float, D>
      <<<(unsigned)((rows_bsh + kRowsDelta - 1) / kRowsDelta), kDeltaThreads,
         0, stream>>>(o, dout, delta, rows_bsh, Sq, H, vec_o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Args A{q,  k,     v,  dout,   lse,    delta,  dq,     dk,
               dv, part,  B,  Sq,     Sk,     H,      Hk,     G,
               splits, causal, window, cap, scale, vec};
  const long long n_dkdv = (long long)nkt * splits * Hk * B;
  const long long n_dq = (long long)nqt * H * B;
  flash_bwd_main<D><<<(unsigned)(n_dkdv + n_dq), C::THREADS, C::smem,
                      stream>>>(A, n_dkdv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long n4 = (long long)B * Sk * Hk * D / 4;
    flash_bwd_merge<float>
        <<<(unsigned)((n4 + kMergeThreads - 1) / kMergeThreads),
           kMergeThreads, 0, stream>>>(part, dk, dv, n4, splits, scale);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// The tiles of the backward at head dim D that kernel.py::bwd_tiles mirrors
// to choose the split count: out[0..3] = rows a block, streamed rows a
// tile, shared memory bytes, blocks an SM (launch bounds).
extern "C" int flash_attention_bwd_config(int D, int* out) {
  switch (D) {
    case 16: return config<16>(out);
    case 32: return config<32>(out);
    case 64: return config<64>(out);
    case 96: return config<96>(out);
    case 128: return config<128>(out);
    case 256: return config<256>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hk, D); lse and the
// scratch delta (B, H, Sq); part, the splits' scratch (2, splits, B, Sk,
// Hk, D) or null with one split; all float32 contiguous.  lse is
// flash_attention_lse_f32's for the same q, k, v and options.  cap <= 0
// means no soft-cap, window <= 0 no sliding window; Sq != Sk takes neither
// a causal mask nor a window.  splits (1 .. H/Hk)
// is the host plan's (kernel.py::bwd_plan); the tiles and grids are this
// source's.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part, void* dq,
    void* dk, void* dv, int B, int Sq, int Sk, int H, int Hk, int D,
    int causal, float cap, int window, int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hk <= 0 || H % Hk || B > 65535 ||
      H > 65535 || (Sq != Sk && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* of = (const float*)o;
  const float* gf = (const float*)dout;
  const float* lf = (const float*)lse;
  float* df = (float*)delta;
  float* pf = (float*)part;
  float* dqf = (float*)dq;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BWD_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return launch<DIM>(qf, kf, vf, of, gf, lf, df, pf, dqf, dkf, dvf, B, Sq, \
                       Sk, H, Hk, causal, cap, window, splits, st);
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

// ---------------------------------------------------------------------------
// flash_attention_bwd_bf16: the same gradient on bf16 inputs.  q, k, v, o
// and dO are bf16, lse is flash_attention_lse_bf16's fp32 (B, H, Sq); dQ,
// dK and dV are written in bf16, every sum runs in fp32 and each output is
// rounded once, at the store.  The plan is the fp32 kernel's: delta, then
// one launch of dK/dV blocks (a key tile, kv head, split of the group's
// heads from kernel.py::bwd_plan, batch row) and dQ blocks (a query tile,
// head, batch row), then the splits' merge in split order where the plan
// splits; no atomics, so a launch repeats the last one bit for bit.
//
// - delta_i = dO_i.o_i from the bf16 o the forward stored (the plain
//   autograd's is the unrounded fp32 o's; chip_smoke.py's phase 2 prints
//   both choices' distance from float64).
// - A block holds R = 64 resident rows (K and V of its keys, or Q and dO of
//   its queries) and streams tiles of BC rows of the other pair through a
//   two-stage cp.async ring (16-byte copies, zero fill past Sq and Sk).
//   Rows are padded by 8 bf16 (16 bytes), so the fragments' 32-bit loads
//   and ldmatrix's rows are free of bank conflicts.
// - Per tile, two phases between block barriers.  (1) Each warp takes 16
//   resident rows x BC / WD streamed columns and computes S (or S^T) and dP
//   (or dP^T) over all of D on bf16 mma.sync.m16n8k16 (the products of two
//   bf16 values are exact in fp32), then P = exp(c - lse) and dS = P (dP -
//   delta) (times 1 - (c / cap)^2 with a cap) in fp32, masked, and stores
//   them to shared memory as bf16.  (2) Each warp takes 16 resident rows x
//   DC columns of D and adds P^T.dO and dS^T.Q (dK/dV blocks) or dS.K (dQ
//   blocks) into fp32 accumulators: A from the stored P or dS, B by
//   ldmatrix.trans from the streamed tile.
// - P and dS enter their products as one bf16 term, their rounding
//   (bf16.cuh's hi): each gradient element sums many products of both
//   signs, so a per-term rounding of 2^-9 stays far below the output's own
//   bf16 rounding (phase 2 holds every product to the float64 bar; the
//   forward's P.V needs a lo term because one dominant key's p carries the
//   output).
// - Sums: one fp32 accumulator a warp per output element across all tiles
//   and heads (at most a few hundred mma steps: far below a bf16 ulp).
// Warps: 4 row groups x WD (D 128: 2, D 256: 4, else 1); BC 64 (32 at D
// 256).  A simple kernel: wgmma and TMA are later work.
// ---------------------------------------------------------------------------
namespace {

using bf16mma::bf16;

template <int D>
struct CfgBw {
  static constexpr int R = 64;                   // resident rows a block
  static constexpr int BC = D == 256 ? 32 : 64;  // streamed rows a tile
  static constexpr int DC = D >= 128 ? 64 : D;   // output columns a warp
  static constexpr int WD = D / DC;              // warps over D
  static constexpr int WARPS = 4 * WD;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NCT = BC / WD / 8;  // score n tiles a warp (phase 1)
  static constexpr int NDT = DC / 8;       // output n tiles a warp (phase 2)
  static constexpr int LD = D + 8;         // row stride (bf16)
  static constexpr int LP = BC + 8;        // P and dS row stride (bf16)
  static constexpr int STAGES = 2;
  // bytes: resident rows (2 tensors), streamed tiles (STAGES x 2 tensors),
  // P and dS, the streamed rows' lse and delta (fp32, STAGES)
  static constexpr int XB = 2 * R * LD * 2;
  static constexpr int YB = STAGES * 2 * BC * LD * 2;
  static constexpr int PB = 2 * R * LP * 2;
  static constexpr int SB = STAGES * 2 * BC * 4;
  static constexpr size_t smem = (size_t)XB + YB + PB + SB;
  static_assert(NCT >= 1 && NDT % 2 == 0 && BC % 16 == 0, "tiles");
  static_assert(smem <= 232448, "flash_attention_bwd_bf16: shared memory");
};

// rows p0 .. p0+n-1 of head h of a bf16 (B, S, NH, D) tensor into dst (row
// stride D + 8), 16 bytes a copy; zeros past S
template <int D, int TH>
__device__ __forceinline__ void load_rows_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               int b, int S, int NH, int h,
                                               int p0, int n) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int e = threadIdx.x; e < n * CH; e += TH) {
    const int r = e / CH, c = (e % CH) * 8, pos = p0 + r;
    const bool ok = pos < S;
    cp_async(dst + r * LD + c,
             ok ? src + (((size_t)b * S + pos) * NH + h) * D + c : src, ok,
             true);
  }
}

// phase 1: a warp's S = X1.Y1^T and dP = X2.Y2^T over all of D, 16 rows
// (x1, x2: the warp's first resident row) x NCT 8-column tiles (y1, y2:
// its first streamed row)
template <class C, int D>
__device__ __forceinline__ void scores_bf16(const bf16* x1, const bf16* y1,
                                            const bf16* x2, const bf16* y2,
                                            float (&s)[C::NCT][4],
                                            float (&dp)[C::NCT][4]) {
  constexpr int LD = C::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < C::NCT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a1[4], a2[4];
    const bf16* r1 = x1 + g * LD + k0 + 2 * t;
    const bf16* r2 = x2 + g * LD + k0 + 2 * t;
    a1[0] = bf16mma::ld32(r1);
    a1[1] = bf16mma::ld32(r1 + 8 * LD);
    a1[2] = bf16mma::ld32(r1 + 8);
    a1[3] = bf16mma::ld32(r1 + 8 * LD + 8);
    a2[0] = bf16mma::ld32(r2);
    a2[1] = bf16mma::ld32(r2 + 8 * LD);
    a2[2] = bf16mma::ld32(r2 + 8);
    a2[3] = bf16mma::ld32(r2 + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < C::NCT; ++nt) {
      const bf16* c1 = y1 + (nt * 8 + g) * LD + k0 + 2 * t;
      const bf16* c2 = y2 + (nt * 8 + g) * LD + k0 + 2 * t;
      bf16mma::mma16(s[nt], a1, bf16mma::ld32(c1), bf16mma::ld32(c1 + 8));
      bf16mma::mma16(dp[nt], a2, bf16mma::ld32(c2), bf16mma::ld32(c2 + 8));
    }
  }
}

// a warp's fragments (16 rows x NCT 8-column tiles) into shared memory as
// bf16, row stride LP; dst: the warp's first row and column
template <class C>
__device__ __forceinline__ void store_bf16(bf16* dst,
                                           const float (&x)[C::NCT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < C::NCT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dst + (g + 8 * i) * C::LP + nt * 8 +
                                   2 * t) =
          bf16mma::pack(x[nt][2 * i], x[nt][2 * i + 1]);
}

// phase 2: acc (16 rows x NDT 8-column tiles) += A.Y, A the warp's 16 rows
// of a stored P or dS (a_s: its first row) over the tile's BC streamed
// rows, Y those rows' DC columns (y: row 0, the warp's first column)
template <class C>
__device__ __forceinline__ void accumulate_bf16(float (&acc)[C::NDT][4],
                                                const bf16* a_s,
                                                const bf16* y) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < C::BC; k0 += 16) {
    uint32_t a[4];
    const bf16* ar = a_s + g * C::LP + k0 + 2 * t;
    a[0] = bf16mma::ld32(ar);
    a[1] = bf16mma::ld32(ar + 8 * C::LP);
    a[2] = bf16mma::ld32(ar + 8);
    a[3] = bf16mma::ld32(ar + 8 * C::LP + 8);
    const bf16* yr =
        y + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::LD + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < C::NDT / 2; ++dp) {
      uint32_t r[4];
      bf16mma::ldsm4t(r, yr + dp * 16);
      bf16mma::mma16(acc[2 * dp], a, r[0], r[1]);
      bf16mma::mma16(acc[2 * dp + 1], a, r[2], r[3]);
    }
  }
}

struct ArgsB {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  float* part;
  int B, Sq, Sk, H, Hk, G, splits, causal, window;
  float cap, scale;
};

// dK and dV of key tile kt, split sp, kv head hk, batch row b
template <int D>
__device__ __forceinline__ void dkdv_block_bf16(const ArgsB& A,
                                                unsigned char* smem, int kt,
                                                int sp, int hk, int b) {
  using C = CfgBw<D>;
  constexpr int R = C::R, BC = C::BC, LD = C::LD, LP = C::LP, TH = C::THREADS,
                ST = C::STAGES;
  const int Sq = A.Sq, Sk = A.Sk, H = A.H, G = A.G;
  const int causal = A.causal, window = A.window;
  bf16* x_s = reinterpret_cast<bf16*>(smem);  // [K, V][R][LD]
  bf16* y_s = x_s + 2 * R * LD;               // [stage][Q, dO][BC][LD]
  bf16* p_s = y_s + ST * 2 * BC * LD;         // [P, dS][R][LP]
  float* st_s = reinterpret_cast<float*>(p_s + 2 * R * LP);  // [stage][lse, delta][BC]
  const int k0 = kt * R;
  const int g0 = sp * G / A.splits, g1 = (sp + 1) * G / A.splits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp / C::WD, cg = warp % C::WD;
  const int c0 = cg * C::NCT * 8;  // phase 1: the warp's streamed columns
  const int kw = k0 + rg * 16;     // the warp's first key

  // the queries that can see a key of the tile
  const int klast = min(Sk, k0 + R) - 1;
  const int qbeg = causal ? k0 : 0;
  const int qend = window > 0 ? min(Sq, klast + window) : Sq;
  const int nq = (qend - qbeg + BC - 1) / BC;
  const int T = (g1 - g0) * nq;

  auto load_y = [&](int stage, int j) {
    const int h = hk * G + g0 + j / nq, q0 = qbeg + (j % nq) * BC;
    bf16* base = y_s + stage * 2 * BC * LD;
    load_rows_bf16<D, TH>(base, A.q, b, Sq, H, h, q0, BC);
    load_rows_bf16<D, TH>(base + BC * LD, A.dout, b, Sq, H, h, q0, BC);
    if (threadIdx.x < 2 * BC) {
      const int pos = q0 + threadIdx.x % BC;
      const float* src = threadIdx.x < BC ? A.lse : A.delta;
      const bool ok = pos < Sq;
      cp_async(st_s + stage * 2 * BC + threadIdx.x,
               ok ? src + ((size_t)b * H + h) * Sq + pos : src, ok, false);
    }
  };
  load_rows_bf16<D, TH>(x_s, A.k, b, Sk, A.Hk, hk, k0, R);
  load_rows_bf16<D, TH>(x_s + R * LD, A.v, b, Sk, A.Hk, hk, k0, R);
  load_y(0, 0);
  cp_commit();

  float acc_k[C::NDT][4], acc_v[C::NDT][4];
#pragma unroll
  for (int dt = 0; dt < C::NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const int st = t % ST, q0 = qbeg + (t % nq) * BC;
    cp_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t-1
    if (t + 1 < T) load_y((t + 1) % ST, t + 1);
    cp_commit();
    const bf16* qy = y_s + st * 2 * BC * LD;
    const bf16* oy = qy + BC * LD;
    const float* lse_c = st_s + st * 2 * BC;
    const float* dl_c = lse_c + BC;
    {
      float sc[C::NCT][4], dp[C::NCT][4];
      scores_bf16<C, D>(x_s + rg * 16 * LD, qy + c0 * LD,
                        x_s + (R + rg * 16) * LD, oy + c0 * LD, sc, dp);
#pragma unroll
      for (int nt = 0; nt < C::NCT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + gq + 8 * (e >> 1);
          const int jc = c0 + nt * 8 + 2 * tq + (e & 1), qpos = q0 + jc;
          const bool vis = key < Sk && qpos < Sq &&
                           (!causal || key <= qpos) &&
                           (window <= 0 || key > qpos - window);
          float p, ds;
          grad_pair(sc[nt][e], dp[nt][e], lse_c[jc], dl_c[jc], vis, A.cap,
                    A.scale, p, ds);
          sc[nt][e] = p;
          dp[nt][e] = ds;
        }
      store_bf16<C>(p_s + rg * 16 * LP + c0, sc);
      store_bf16<C>(p_s + (R + rg * 16) * LP + c0, dp);
    }
    __syncthreads();  // P^T and dS^T of the tile are stored
    accumulate_bf16<C>(acc_v, p_s + rg * 16 * LP, oy + cg * C::DC);
    accumulate_bf16<C>(acc_k, p_s + (R + rg * 16) * LP, qy + cg * C::DC);
  }
  cp_wait<0>();

  const size_t n = (size_t)A.B * Sk * A.Hk * D;  // one split's elements
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + gq + 8 * i;
    if (key >= Sk) continue;
    const size_t row = (((size_t)b * Sk + key) * A.Hk + hk) * D;
#pragma unroll
    for (int dt = 0; dt < C::NDT; ++dt) {
      const int d = cg * C::DC + dt * 8 + 2 * tq;
      if (A.splits == 1) {
        *reinterpret_cast<uint32_t*>(A.dk + row + d) =
            bf16mma::pack(acc_k[dt][2 * i] * A.scale,
                          acc_k[dt][2 * i + 1] * A.scale);
        *reinterpret_cast<uint32_t*>(A.dv + row + d) =
            bf16mma::pack(acc_v[dt][2 * i], acc_v[dt][2 * i + 1]);
      } else {
        *reinterpret_cast<float2*>(A.part + sp * n + row + d) =
            make_float2(acc_k[dt][2 * i], acc_k[dt][2 * i + 1]);
        *reinterpret_cast<float2*>(A.part + (A.splits + sp) * n + row + d) =
            make_float2(acc_v[dt][2 * i], acc_v[dt][2 * i + 1]);
      }
    }
  }
}

// dQ of the query tile at q0, query head h, batch row b
template <int D>
__device__ __forceinline__ void dq_block_bf16(const ArgsB& A,
                                              unsigned char* smem, int q0,
                                              int h, int b) {
  using C = CfgBw<D>;
  constexpr int R = C::R, BC = C::BC, LD = C::LD, LP = C::LP, TH = C::THREADS,
                ST = C::STAGES;
  const int Sq = A.Sq, Sk = A.Sk, H = A.H, Hk = A.Hk;
  const int causal = A.causal, window = A.window;
  bf16* x_s = reinterpret_cast<bf16*>(smem);  // [Q, dO][R][LD]
  bf16* y_s = x_s + 2 * R * LD;               // [stage][K, V][BC][LD]
  bf16* p_s = y_s + ST * 2 * BC * LD;         // dS [R][LP]
  const int hk = h / A.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp / C::WD, cg = warp % C::WD;
  const int c0 = cg * C::NCT * 8;
  const int qw = q0 + rg * 16;  // the warp's first query

  // the keys any row of the tile sees (flash_attention.cu's range)
  const int kend = causal ? min(Sk, q0 + R) : Sk;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int T = (kend - kbeg + BC - 1) / BC;

  auto load_y = [&](int stage, int kk0) {
    bf16* base = y_s + stage * 2 * BC * LD;
    load_rows_bf16<D, TH>(base, A.k, b, Sk, Hk, hk, kk0, BC);
    load_rows_bf16<D, TH>(base + BC * LD, A.v, b, Sk, Hk, hk, kk0, BC);
  };
  load_rows_bf16<D, TH>(x_s, A.q, b, Sq, H, h, q0, R);
  load_rows_bf16<D, TH>(x_s + R * LD, A.dout, b, Sq, H, h, q0, R);
  load_y(0, kbeg);
  cp_commit();

  float lr[2], dr[2];  // this thread's two rows' lse and delta (0 past Sq)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = qw + gq + 8 * i;
    const size_t at = ((size_t)b * H + h) * Sq + pos;
    lr[i] = pos < Sq ? __ldg(A.lse + at) : 0.0f;
    dr[i] = pos < Sq ? __ldg(A.delta + at) : 0.0f;
  }
  float acc[C::NDT][4];
#pragma unroll
  for (int dt = 0; dt < C::NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const int st = t % ST, kk0 = kbeg + t * BC;
    cp_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t-1
    if (t + 1 < T) load_y((t + 1) % ST, kk0 + BC);
    cp_commit();
    const bf16* ky = y_s + st * 2 * BC * LD;
    const bf16* vy = ky + BC * LD;
    {
      float sc[C::NCT][4], dp[C::NCT][4];
      scores_bf16<C, D>(x_s + rg * 16 * LD, ky + c0 * LD,
                        x_s + (R + rg * 16) * LD, vy + c0 * LD, sc, dp);
#pragma unroll
      for (int nt = 0; nt < C::NCT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, qpos = qw + gq + 8 * i;
          const int key = kk0 + c0 + nt * 8 + 2 * tq + (e & 1);
          const bool vis = qpos < Sq && key < Sk &&
                           (!causal || key <= qpos) &&
                           (window <= 0 || key > qpos - window);
          float p, ds;
          grad_pair(sc[nt][e], dp[nt][e], lr[i], dr[i], vis, A.cap, A.scale,
                    p, ds);
          dp[nt][e] = ds;
        }
      store_bf16<C>(p_s + rg * 16 * LP + c0, dp);
    }
    __syncthreads();  // dS of the tile is stored
    accumulate_bf16<C>(acc, p_s + rg * 16 * LP, ky + cg * C::DC);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = qw + gq + 8 * i;
    if (pos >= Sq) continue;
    bf16* row = A.dq + (((size_t)b * Sq + pos) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < C::NDT; ++dt)
      *reinterpret_cast<uint32_t*>(row + cg * C::DC + dt * 8 + 2 * tq) =
          bf16mma::pack(acc[dt][2 * i] * A.scale,
                        acc[dt][2 * i + 1] * A.scale);
  }
}

// both kinds of block in one launch, in the fp32 kernel's order
template <int D>
__global__ void __launch_bounds__(CfgBw<D>::THREADS, 1)
flash_bwd_bf16_main(const ArgsB A, long long n_dkdv) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int R = CfgBw<D>::R;
  long long i = blockIdx.x;
  if (i < n_dkdv) {
    const int nt = (A.Sk + R - 1) / R;  // key tiles
    const int x = (int)(i % ((long long)nt * A.splits));
    i /= (long long)nt * A.splits;
    dkdv_block_bf16<D>(A, smem_b, x % nt, x / nt, (int)(i % A.Hk),
                       (int)(i / A.Hk));
  } else {
    const int nt = (A.Sq + R - 1) / R;  // query tiles
    i -= n_dkdv;
    const int x = (int)(i % nt);
    i /= nt;
    dq_block_bf16<D>(A, smem_b, (nt - 1 - x) * R, (int)(i % A.H),
                     (int)(i / A.H));
  }
}

template <int D>
int config_bf16(int* out) {
  using C = CfgBw<D>;
  out[0] = C::R;
  out[1] = C::BC;
  out[2] = (int)C::smem;
  out[3] = C::THREADS;
  return 0;
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const bf16* dout, const float* lse, float* delta, float* part,
                bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Sk, int H,
                int Hk, int causal, float cap, int window, int splits,
                cudaStream_t stream) {
  using C = CfgBw<D>;
  const int G = H / Hk;
  const int nkt = (Sk + C::R - 1) / C::R, nqt = (Sq + C::R - 1) / C::R;
  if (splits < 1 || splits > G || (splits > 1 && part == nullptr) ||
      ((long long)nkt * splits * Hk + (long long)nqt * H) * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_bf16_main<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long rows_bsh = (long long)B * Sq * H;
  constexpr int kRowsDelta = DeltaRows<bf16, D>::ROWS;
  flash_bwd_delta<bf16, D>
      <<<(unsigned)((rows_bsh + kRowsDelta - 1) / kRowsDelta), kDeltaThreads,
         0, stream>>>(o, dout, delta, rows_bsh, Sq, H, true);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ArgsB A{q,  k,  v,  dout, lse,    delta,  dq,     dk,     dv,
                part, B, Sq, Sk,   H,      Hk,     G,      splits, causal,
                window, cap, scale};
  const long long n_dkdv = (long long)nkt * splits * Hk * B;
  const long long n_dq = (long long)nqt * H * B;
  flash_bwd_bf16_main<D><<<(unsigned)(n_dkdv + n_dq), C::THREADS, C::smem,
                           stream>>>(A, n_dkdv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long n4 = (long long)B * Sk * Hk * D / 4;
    flash_bwd_merge<bf16>
        <<<(unsigned)((n4 + kMergeThreads - 1) / kMergeThreads),
           kMergeThreads, 0, stream>>>(part, dk, dv, n4, splits, scale);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// The bf16 backward's tiles at head dim D that kernel.py::bwd_bf16_tiles
// mirrors: out[0..3] = resident rows a block, streamed rows a tile, shared
// memory bytes, threads a block.
extern "C" int flash_attention_bwd_bf16_config(int D, int* out) {
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

// flash_attention_bwd_f32's arguments on bf16 tensors: q, o, dout, dq (B,
// Sq, H, D) and k, v, dk, dv (B, Sk, Hk, D) bf16, 16-byte aligned; lse
// (flash_attention_lse_bf16's) and the scratch delta (B, H, Sq) fp32; part
// the splits' fp32 scratch (2, splits, B, Sk, Hk, D) or null with one split.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part, void* dq,
    void* dk, void* dv, int B, int Sq, int Sk, int H, int Hk, int D,
    int causal, float cap, int window, int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hk <= 0 || H % Hk || B > 65535 ||
      H > 65535 || (Sq != Sk && (causal || window > 0)) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
        (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) &
       15u))
    return (int)cudaErrorInvalidValue;
  const bf16* qb = (const bf16*)q;
  const bf16* kb = (const bf16*)k;
  const bf16* vb = (const bf16*)v;
  const bf16* ob = (const bf16*)o;
  const bf16* gb = (const bf16*)dout;
  const float* lf = (const float*)lse;
  float* df = (float*)delta;
  float* pf = (float*)part;
  bf16* dqb = (bf16*)dq;
  bf16* dkb = (bf16*)dk;
  bf16* dvb = (bf16*)dv;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BWD_BF16_CASE(DIM)                                            \
  case DIM:                                                                 \
    return launch_bf16<DIM>(qb, kb, vb, ob, gb, lf, df, pf, dqb, dkb, dvb,  \
                            B, Sq, Sk, H, Hk, causal, cap, window, splits,  \
                            st);
  switch (D) {
    FLASH_BWD_BF16_CASE(16)
    FLASH_BWD_BF16_CASE(32)
    FLASH_BWD_BF16_CASE(64)
    FLASH_BWD_BF16_CASE(96)
    FLASH_BWD_BF16_CASE(128)
    FLASH_BWD_BF16_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_BF16_CASE
}
