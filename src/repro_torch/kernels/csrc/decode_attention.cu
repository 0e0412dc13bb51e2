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
// tail) are never read into a sum: the tile loader zero-fills them.
//
// Bound on an H100: bytes.  Each live key costs 2*D*4 bytes of K and V
// against 4*D operations per query head of its group, G/2 operations per
// byte, below the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20) for every
// G <= 16.  chatglm3-6b's decode tick with slots of 4100 and 4250 keys
// reads 17 MB per layer: 5.2 us.
//
// Design: one launch.  The work follows the live keys, read on the card.
// The grid is (Hk, max(nb, B)): each kv head has a budget of nb blocks
// (the wrapper's: the blocks the card holds at once,
// decode_attention_occupancy, over the Hk kv heads, twice that where an
// SM holds two blocks or more; kernel.py grid_waves).  Every sequence
// takes one, and the other nb - B are shared over the B sequences in
// proportion to their live keys.  Every block reads all B kv_len values
// (one a lane, in parallel; reading them one after another cost a short
// tick 1.4-1.9 us) and computes the same plan (split_plan in kernel.py
// mirrors it):
// sequence b of `live` keys gets 1 + floor((nb - B) * live / total live)
// splits, at most one per kMinKeys keys (and kMaxSplits), of equal size
// rounded up to whole 32-key tiles.  So a tick's one long slot takes
// nearly the whole budget and its three short ones a block each, two long
// slots share it, a slot of a few dozen keys is one split whatever the
// cache's size, and the blocks never outnumber the budget.
// Block y < B is split 0 of sequence y (a tick's short slots start at
// once); the blocks from B on are the other splits, sequence by sequence;
// a block past the plan returns at once and writes nothing.
// A sequence of one split writes its output directly; otherwise each
// block writes its partial (acc, m, l) and bumps a counter per (b, hk);
// the block that brings it to nsplit merges the nsplit partials by
// logsumexp, the weighted partials in split order and the weights' max
// and denominator by a fixed warp tree (deterministic whichever block is
// last; no atomics in the sums), and resets the counter to 0 for the next
// call on the stream.  Only live splits are written and read.
//
// In a block, 4 warps walk the split in 32-key tiles of K and V, copied
// with 16-byte cp.async into a ring of shared-memory stages (4 below D
// 256: tiles t+1 .. t+3 load while tile t is computed; with one tile in
// flight a block waits out the memory latency at every tile), one
// __syncthreads a tile, each tile read once for all G query rows of the
// kv head; each warp takes 8 keys of a tile.  Two routes
// compute a tile, both nearer float64 than the plain version's fp32 sums:
// the dense zoo (no soft-cap) has scores in the hundreds, where a score
// rounded ~1e-4 off moves a near-tied softmax (a lane tree in fp32 missed
// the card == CPU logits on glm4-9b).
//  - G >= 3 (chatglm3-6b, glm4-9b: 16): the G rows are the m16 rows of
//    TF32 mma.sync.m16n8k8 (zero rows past G), the warp's 8 keys one n8
//    tile, in flash_attention.cu's arithmetic: Veltkamp splits, Q.K^T as
//    3xTF32 (q split once per block, K as it is read), hi*hi summed two d
//    steps at a time in a fresh accumulator and added with fp32 adds, P.V
//    in six terms on three-part P and V (tests/test_torch_flash_split.py
//    checks the scheme at decode's shapes).  The online softmax runs on
//    the accumulator fragments (row max over a row's 4 lanes), P goes to
//    P.V's A fragment without a shuffle, O stays in registers.
//  - G = 1 or 2 (phi3-mini, gemma2-2b), where 16-row tiles would be mostly
//    padding: CUDA cores, 4 lanes a key, each summing a quarter of D in
//    fp64 (q kept as doubles, k converted as read: exact products, the sum
//    rounded to fp32 once), then two xor shuffles; a warp's softmax by xor
//    shuffles over its 8 keys, P through shared memory, P*V in fp32 with
//    lane l on head dims l, l+32, ...  G*D fp64 multiply-adds a key at
//    half the fp32 rate stay under the byte time.
// The bf16 kernel (decode_attention_bf16) is decode_attention_bf16.cu.
// The 4 warps' states merge in warp order at the end of a split.  An
// empty warp, block or split carries m = -1e30, l = 0, acc = 0 (the
// reference's NEG_INF, never -inf, so no exp(-inf - -inf) = NaN); a
// sequence with no live key gets zeros.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8 * kWarps;   // keys per tile: 8 (one n8 tile) a warp
constexpr int kRows = 16;           // the mma's m16: G query rows, padded
constexpr int kMaxSplits = 64;      // splits of one sequence at most
constexpr int kMinKeys = 128;       // the fewest live keys a split takes
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// R = 0: the tensor-core route, G <= 16 rows padded to the mma's 16;
// R = G (1 or 2): fp64 scores on the CUDA cores.  T: the type of q, the
// K/V tiles and o (float)
template <typename T, int D, int R>
struct Cfg {
  static constexpr bool kMma = R == 0;
  // K's row stride: the mma route's 64-bit fragment loads, or the
  // CUDA-core route's 16-byte loads (two keys a quarter warp, 64 bytes
  // apart in the banks), free of bank conflicts; V's: 32-bit loads
  static constexpr int LK = kMma ? D + 8 : (D % 32 ? D : D + 16);
  static constexpr int LV = kMma ? D + 4 : D;
  static constexpr int DK = D / 8;          // the mma's 8-wide d steps
  static constexpr int DT = (D + 31) / 32;  // CUDA cores: P*V dims a lane
  // q (bytes): hi and lo in fp32 (mma), or R rows of doubles
  static constexpr size_t q_bytes =
      kMma ? 2 * sizeof(float) * kRows * LK : sizeof(double) * R * D;
  static constexpr size_t stage = sizeof(T) * kTile * (LK + LV);   // bytes
  // stages of K and V in the ring: kStages - 1 tiles in flight while one
  // is computed, as many as shared memory holds (227 KB a block)
  static constexpr int kStages = D < 256 ? 4 : kMma ? 2 : 3;
  static constexpr size_t merge = sizeof(float) * kWarps * kRows * D;
  static_assert(kStages * stage >= sizeof(float) * 2 * kMaxSplits * kRows,
                "merge weights");
  // the stages, reused for the warps' merge
  static constexpr size_t smem =
      q_bytes + (kStages * stage > merge ? kStages * stage : merge);
};

// x = hi + lo exactly: hi is x rounded to 11 significant bits (a TF32
// value), by Veltkamp's split with 2^13 + 1 in fp32 arithmetic (no
// contraction: each step rounds); lo the rest (flash_attention.cu's split)
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

// x = hi + mid + lo exactly, three TF32 values (lo holds x's last 2 bits)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  float h, r, m, l;
  splitf(x, h, r);
  splitf(r, m, l);
  hi = __float_as_uint(h);
  mid = __float_as_uint(m);
  lo = __float_as_uint(l);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one 16-byte (vec) or 4-byte copy into shared memory; zeros if !valid
__device__ __forceinline__ void cp_async(void* dst, const void* src,
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

// the visible keys [lo, len) of a sequence whose cache holds kv keys
__device__ __forceinline__ int live_range(int kv, int S, int window,
                                          int& lo) {
  const int len = min(kv, S);
  lo = window > 0 ? max(0, kv - window) : 0;
  return len;
}

// splits (n) and keys per split (chunk) of a sequence of `live` keys, with
// `extra` blocks beyond one a sequence shared by sequences of `total` live
// keys
__device__ __forceinline__ void plan(int live, int extra, long long total,
                                     int& n, int& chunk) {
  n = 1 + (extra > 0 && total > 0 ? (int)((long long)extra * live / total)
                                  : 0);
  n = max(1, min(n, min(kMaxSplits, (live + kMinKeys - 1) / kMinKeys)));
  chunk = (live + n - 1) / n;
  chunk = max(kTile, (chunk + kTile - 1) / kTile * kTile);
  n = max(1, (live + chunk - 1) / chunk);
}

// keys j0 .. j0+31 of K and V into one stage; zeros at and past k_end
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* ks, const T* k, const T* v,
                                          size_t base, size_t row, int j0,
                                          int k_end, bool vec) {
  using C = Cfg<T, D, R>;
  T* vs = ks + kTile * C::LK;
  // values a copy: 16 bytes, or 4 where a base is not 16-byte aligned
  const int w = (vec ? 16 : 4) / (int)sizeof(T), per_row = D / w;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int j = e / per_row, c = (e % per_row) * w;
    const bool ok = j0 + j < k_end;
    const size_t off = ok ? base + (size_t)(j0 + j) * row + c : 0;
    cp_async(ks + j * C::LK + c, k + off, ok, vec);
    cp_async(vs + j * C::LV + c, v + off, ok, vec);
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ o, float* __restrict__ ws,
              int* __restrict__ count, int B, int S, int Hk, int G, int nb,
              int window, float cap, double scale, bool vec) {
  using C = Cfg<T, D, R>;
  constexpr int LK = C::LK, LV = C::LV, DK = C::DK, DT = C::DT;
  // per thread: rows tracked, accumulator groups and their width (mma:
  // fragment rows gq and gq+8, D/8 tiles of 4; CUDA cores: R rows, dims
  // lane + 32t)
  constexpr int NR = C::kMma ? 2 : R;
  constexpr int NA = C::kMma ? DK : DT;
  constexpr int NE = C::kMma ? 4 : R;
  extern __shared__ __align__(16) unsigned char smem[];
  // the stages: K [kTile][LK], V after, each stage C::stage bytes
  unsigned char* kv_s = smem + C::q_bytes;
  auto stage_at = [&](int t) {
    return reinterpret_cast<T*>(kv_s + (size_t)t * C::stage);
  };
  // [kWarps][kRows][D], after the tiles
  float* mrg_s = reinterpret_cast<float*>(kv_s);
  // the last block's weights per split and row, after the partials
  float (*wm_s)[kRows] = reinterpret_cast<float (*)[kRows]>(kv_s);
  float (*wl_s)[kRows] = wm_s + kMaxSplits;
  __shared__ float m_s[kWarps][kRows], l_s[kWarps][kRows];
  __shared__ float mb_s[kRows], den_s[kRows];
  __shared__ float p_s[kWarps][8][2];  // CUDA cores: P of a warp's 8 keys
  __shared__ int last_s;

  const int hk = blockIdx.x, y = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // mma: fragment row and column group; CUDA cores: key and quarter of D
  const int gq = lane >> 2, tq = lane & 3;

  // the plan (kernel.py split_plan), computed alike by every warp with
  // one sequence a lane, 32 at a time (one load of kv_len a lane, no
  // barrier): this block's sequence b and split si, b's splits and their
  // size, and `first`, where b's splits past the first start among the
  // blocks from B on
  long long total = 0;
  for (int c = 0; c < B; c += 32) {
    int lo_i = 0;
    const int len_i =
        c + lane < B ? live_range(kv_len[c + lane], S, window, lo_i) : 0;
    long long t = max(len_i - lo_i, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    total += t;
  }
  int b = -1, si = 0, nsplit = 1, chunk = kTile, first = 0, lo = 0, len = 0;
  for (int c = 0, off = 0; c < B; c += 32) {
    const int i = c + lane;
    int lo_i = 0, len_i = 0, n = 1, ch = kTile;
    if (i < B) {
      len_i = live_range(kv_len[i], S, window, lo_i);
      plan(max(len_i - lo_i, 0), nb - B, total, n, ch);
    }
    // the splits past the first of the sequences before i: a scan
    const int own = i < B ? n - 1 : 0;
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = off + incl - own;
    const int e = y - B - excl;        // y's place among i's other splits
    const unsigned hit = __ballot_sync(
        kFull, i < B && (y == i || (y >= B && e >= 0 && e < n - 1)));
    if (hit) {
      const int src = __ffs(hit) - 1;
      b = c + src;
      nsplit = __shfl_sync(kFull, n, src);
      chunk = __shfl_sync(kFull, ch, src);
      first = __shfl_sync(kFull, excl, src);
      lo = __shfl_sync(kFull, lo_i, src);
      len = __shfl_sync(kFull, len_i, src);
      si = y == b ? 0 : y - B - first + 1;
    }
    off += __shfl_sync(kFull, incl, 31);
  }
  if (b < 0) return;                  // past the plan
  const int pair = b * Hk + hk;
  const int k_beg = lo + si * chunk;
  const int k_end = min(len, k_beg + chunk);
  const int ntile = max(0, (k_end - k_beg + kTile - 1) / kTile);

  const int H = Hk * G;
  const size_t row = (size_t)Hk * D;     // stride between positions
  const size_t base = ((size_t)b * S * Hk + hk) * D;
  constexpr int NS = C::kStages;
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {  // one commit group per stage, even empty
    if (t < ntile)
      load_tile<T, D, R>(stage_at(t), k, v, base, row, k_beg + t * kTile,
                         k_end, vec);
    cp_commit();
  }
  const T* qb = q + ((size_t)b * H + hk * G) * D;
  // fp32 mma: [kRows][LK] q's hi, zero rows >= G, then [kRows][LK] q's lo
  float* qh_s = reinterpret_cast<float*>(smem);
  float* ql_s = qh_s + kRows * LK;
  double* qd_s = reinterpret_cast<double*>(smem);   // CUDA cores: [R][D]
  if constexpr (C::kMma) {
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float hi = 0.0f, lo_ = 0.0f;
      if (r < G) splitf(qb[e], hi, lo_);
      qh_s[r * LK + d] = hi;
      ql_s[r * LK + d] = lo_;
    }
  } else {
    for (int e = tid; e < R * D; e += kThreads) qd_s[e] = (double)qb[e];
  }

  float acc[NA][NE], m[NR], l[NR];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  for (int t = 0; t < ntile; ++t) {
    const int j0 = k_beg + t * kTile;
    const T* ks = stage_at(t % NS);
    const T* vs = ks + kTile * LK;
    cp_wait<NS - 2>();                   // tile t (and q) have landed
    __syncthreads();                     // and tile t-1's stage is consumed
    if (t + NS - 1 < ntile)
      load_tile<T, D, R>(stage_at((t + NS - 1) % NS), k, v, base, row,
                         j0 + (NS - 1) * kTile, k_end, vec);
    cp_commit();
    if constexpr (C::kMma) {
      // S = Q.K^T on the warp's 8 keys.  k-index t of each 8-wide d step
      // stands for d = 2t and t+4 for d = 2t+1 (Q and K alike).  Cross
      // terms in two accumulators over D; hi*hi in a fresh one per two d
      // steps, added to s with fp32 adds
      const int qoff = gq * LK + 2 * tq;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float sx[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const float* kr = ks + (warp * 8 + gq) * LK + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < DK; kk += 2) {
        float tt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d0 = (kk + h) * 8;
          const float2 h0 = *reinterpret_cast<const float2*>(qh_s + qoff + d0);
          const float2 h1 =
              *reinterpret_cast<const float2*>(qh_s + qoff + 8 * LK + d0);
          const float2 l0 = *reinterpret_cast<const float2*>(ql_s + qoff + d0);
          const float2 l1 =
              *reinterpret_cast<const float2*>(ql_s + qoff + 8 * LK + d0);
          const uint32_t ahi[4] = {
              __float_as_uint(h0.x), __float_as_uint(h1.x),
              __float_as_uint(h0.y), __float_as_uint(h1.y)};
          const uint32_t alo[4] = {
              __float_as_uint(l0.x), __float_as_uint(l1.x),
              __float_as_uint(l0.y), __float_as_uint(l1.y)};
          const float2 kv2 = *reinterpret_cast<const float2*>(kr + d0);
          uint32_t bh0, bl0, bh1, bl1;
          split(kv2.x, bh0, bl0);
          split(kv2.y, bh1, bl1);
          mma(sx[h], alo, bh0, bh1);
          mma(sx[h], ahi, bl0, bl1);
          mma(tt, ahi, bh0, bh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += tt[e];
      }
      // scale, cap, mask; s[e] is row gq + 8*(e>>1), key 2*tq + (e&1) of
      // the warp's 8
      bool ok[4];
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = (s[e] + (sx[0][e] + sx[1][e])) * (float)scale;
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        ok[e] = gq + 8 * i < G && j0 + warp * 8 + 2 * tq + (e & 1) < k_end;
        s[e] = ok[e] ? x : kNegInf;
        tmax[i] = fmaxf(tmax[i], s[e]);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 2));
        const float m_new = fmaxf(m[i], tmax[i]);
        alpha[i] = expf(m[i] - m_new);   // 0 before the row's first key
        m[i] = m_new;
      }
      // P as P.V's A fragment, in three exact parts: k-index t is key 2t,
      // t+4 is key 2t+1, so the accumulator's layout needs no shuffle
      uint32_t phi[4], pmi[4], plo[4];
      float rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ok[e] ? expf(s[e] - m[e >> 1]) : 0.0f;
        rsum[e >> 1] += p;
        const int a = (e == 1) ? 2 : (e == 2) ? 1 : e;
        split3(p, phi[a], pmi[a], plo[a]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
      // P.V in six terms on three-part P and V (the dropped ones are below
      // 2^-33 of a product); per 8 head dims a fresh accumulator for hi*hi
      // and one for the other five, added to O with an fp32 add.  A key
      // past k_end has p = 0 and v = 0 (zero-filled): it adds exactly 0
      const float* vr = vs + (warp * 8 + 2 * tq) * LV + gq;
#pragma unroll
      for (int dt = 0; dt < DK; ++dt) {
        uint32_t bh0, bm0, bl0, bh1, bm1, bl1;
        split3(vr[dt * 8], bh0, bm0, bl0);
        split3(vr[dt * 8 + LV], bh1, bm1, bl1);
        float tb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float tx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(tx, plo, bh0, bh1);
        mma(tx, phi, bl0, bl1);
        mma(tx, pmi, bm0, bm1);
        mma(tx, pmi, bh0, bh1);
        mma(tx, phi, bm0, bm1);
        mma(tb, phi, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[dt][e] = fmaf(acc[dt][e], alpha[e >> 1], tb[e] + tx[e]);
      }
    } else {
      // scores: lane (gq, tq) takes key warp*8 + gq and d = 16c + 4tq ..
      // +3, in fp64 (two chains over c), then two xor shuffles
      const int kq = warp * 8 + gq;
      double dot[R][2];
#pragma unroll
      for (int g = 0; g < R; ++g) dot[g][0] = dot[g][1] = 0.0;
      const T* kr = ks + kq * LK + 4 * tq;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + 16 * c);
        const double k0 = k4.x, k1 = k4.y, k2 = k4.z, k3 = k4.w;
#pragma unroll
        for (int g = 0; g < R; ++g) {
          const double* qr = qd_s + g * D + 16 * c + 4 * tq;
          const double2 qa = *reinterpret_cast<const double2*>(qr);
          const double2 qc = *reinterpret_cast<const double2*>(qr + 2);
          double x = fma(qa.x, k0, dot[g][c & 1]);
          x = fma(qa.y, k1, x);
          x = fma(qc.x, k2, x);
          dot[g][c & 1] = fma(qc.y, k3, x);
        }
      }
      const bool ok = j0 + kq < k_end;
#pragma unroll
      for (int g = 0; g < R; ++g) {
        double d = dot[g][0] + dot[g][1];
        d += __shfl_xor_sync(kFull, d, 1);
        d += __shfl_xor_sync(kFull, d, 2);
        float x = (float)(d * scale);
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        x = ok ? x : kNegInf;
        // the warp's 8 keys: lanes 4 apart hold different keys
        float mx = fmaxf(x, __shfl_xor_sync(kFull, x, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);  // 0 before the first key
        const float p = ok ? expf(x - m_new) : 0.0f;
        float ps = p + __shfl_xor_sync(kFull, p, 4);
        ps += __shfl_xor_sync(kFull, ps, 8);
        ps += __shfl_xor_sync(kFull, ps, 16);
        l[g] = l[g] * alpha + ps;
        m[g] = m_new;
#pragma unroll
        for (int u = 0; u < DT; ++u) acc[u][g] *= alpha;
        if (tq == g) p_s[warp][gq][g] = p;
      }
      __syncwarp();
      // P*V over the warp's 8 keys in order, lane l on dims l, l+32, ...;
      // a key past k_end has p = 0 and v = 0 (zero-filled): it adds 0
#pragma unroll 2
      for (int u = 0; u < 8; ++u) {
        const T* vr = vs + (warp * 8 + u) * LV;
        float vv[DT];
#pragma unroll
        for (int t2 = 0; t2 < DT; ++t2) {
          const int d = lane + 32 * t2;
          vv[t2] = d < D ? vr[d] : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < R; ++g) {
          const float p = p_s[warp][u][g];
#pragma unroll
          for (int t2 = 0; t2 < DT; ++t2)
            acc[t2][g] = fmaf(p, vv[t2], acc[t2][g]);
        }
      }
    }
  }
  cp_wait<0>();

  // the warps' states, in warp order (mrg_s reuses the stages)
  if constexpr (C::kMma) {
    // l was a partial sum per lane
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      if (tq == 0) {
        m_s[warp][gq + 8 * i] = m[i];
        l_s[warp][gq + 8 * i] = l[i];
      }
    }
  } else if (lane == 0) {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  if constexpr (C::kMma) {
    float wt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mb = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, m_s[w][gq + 8 * i]);
      wt[i] = expf(m[i] - mb);
    }
#pragma unroll
    for (int dt = 0; dt < DK; ++dt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            mrg_s + (warp * kRows + gq + 8 * i) * D + dt * 8 + 2 * tq) =
            make_float2(acc[dt][2 * i] * wt[i], acc[dt][2 * i + 1] * wt[i]);
  } else {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      float mb = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, m_s[w][g]);
      const float wt = expf(m[g] - mb);
#pragma unroll
      for (int t2 = 0; t2 < DT; ++t2) {
        const int d = lane + 32 * t2;
        if (d < D) mrg_s[(warp * kRows + g) * D + d] = acc[t2][g] * wt;
      }
    }
  }
  if (tid < G) {
    float mb = kNegInf, lb = 0.0f;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, m_s[w][tid]);
    for (int w = 0; w < kWarps; ++w)
      lb += l_s[w][tid] * expf(m_s[w][tid] - mb);
    mb_s[tid] = mb;
    den_s[tid] = lb;
  }
  __syncthreads();

  // rows r < G of the block's state: element e = r*D + d
  T* ob = o + ((size_t)b * H + hk * G) * D;
  if (nsplit == 1) {
    for (int e = tid; e < G * D; e += kThreads) {
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += mrg_s[w * kRows * D + e];
      ob[e] = a / fmaxf(den_s[e / D], 1e-30f);
    }
    return;
  }

  // partial of this split in block slot y of kv head hk: acc (G, D) in
  // the first region of ws, m and l (G each) in the second; split s of b
  // is in slot b (s = 0) or B + first + s - 1
  const int GD = G * D, NY = gridDim.y;
  float* acc_h = ws + (size_t)hk * NY * GD;
  float* ml_h = ws + (size_t)Hk * NY * GD + (size_t)hk * NY * 2 * G;
  for (int e = tid; e < GD; e += kThreads) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += mrg_s[w * kRows * D + e];
    acc_h[(size_t)y * GD + e] = a;
  }
  if (tid < G) {
    ml_h[y * 2 * G + tid] = mb_s[tid];
    ml_h[y * 2 * G + G + tid] = den_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(count + pair, 1);
    last_s = prev == nsplit - 1;
  }
  __syncthreads();
  if (!last_s) return;

  // the last block of (b, hk): the nsplit partials by logsumexp, in split
  // order, 16 bytes a load (L2 reads: other SMs wrote them)
  __threadfence();
  auto slot = [&](int sp) { return sp == 0 ? b : B + first + sp - 1; };
  for (int i = tid; i < nsplit * G; i += kThreads) {
    const int sp = i / G, g = i % G;
    wm_s[sp][g] = __ldcg(ml_h + slot(sp) * 2 * G + g);
    wl_s[sp][g] = __ldcg(ml_h + slot(sp) * 2 * G + G + g);
  }
  __syncthreads();
  // each split's weight exp(m - max) and the denominator, a warp a row:
  // lane l takes splits l and l + 32, max and sum by a fixed shuffle tree
  // (deterministic whichever block merges)
  static_assert(kMaxSplits <= 64, "two splits a lane");
  for (int g = warp; g < G; g += kWarps) {
    float mv[2], lv[2];
    float mg = kNegInf;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int sp = lane + 32 * u;
      mv[u] = sp < nsplit ? wm_s[sp][g] : kNegInf;
      lv[u] = sp < nsplit ? wl_s[sp][g] : 0.0f;
      mg = fmaxf(mg, mv[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mg = fmaxf(mg, __shfl_xor_sync(kFull, mg, o));
    float den = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int sp = lane + 32 * u;
      if (sp < nsplit) {
        const float w = expf(mv[u] - mg);
        wm_s[sp][g] = w;
        den += lv[u] * w;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(kFull, den, o);
    if (lane == 0) den_s[g] = den;
  }
  __syncthreads();
  constexpr int kPer = (kRows * D / 4 + kThreads - 1) / kThreads;
  const float4* acc4 = reinterpret_cast<const float4*>(acc_h);
  float4 num[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) num[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int sp = 0; sp < nsplit; ++sp) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e4 = tid + i * kThreads;
      if (4 * e4 < GD) {
        const float4 x = __ldcg(acc4 + (size_t)slot(sp) * (GD / 4) + e4);
        const float w = wm_s[sp][4 * e4 / D];
        num[i].x = fmaf(x.x, w, num[i].x);
        num[i].y = fmaf(x.y, w, num[i].y);
        num[i].z = fmaf(x.z, w, num[i].z);
        num[i].w = fmaf(x.w, w, num[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e4 = tid + i * kThreads;
    if (4 * e4 < GD) {
      const float den = fmaxf(den_s[4 * e4 / D], 1e-30f);
      *reinterpret_cast<float4*>(ob + 4 * e4) =
          make_float4(num[i].x / den, num[i].y / den, num[i].z / den,
                      num[i].w / den);
    }
  }
  if (tid == 0) count[pair] = 0;         // ready for the next call
}

// dynamic beside ~1 KB of static shared memory: opt in past 48 KB
template <typename T, int D, int R>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(decode_kernel<T, D, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Cfg<T, D, R>::smem);
}

template <typename T, int D, int R>
int occupancy(int* blocks) {
  const cudaError_t err = opt_in<T, D, R>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_kernel<T, D, R>, kThreads, Cfg<T, D, R>::smem);
}

template <typename T, int D, int R>
int launch(const T* q, const T* k, const T* v, const int* kv_len, T* o,
           float* ws, int* count, int B, int S, int Hk, int G, int nb,
           float cap, int window, cudaStream_t stream) {
  using C = Cfg<T, D, R>;
  {
    const cudaError_t err = opt_in<T, D, R>();
    if (err != cudaSuccess) return (int)err;
  }
  // every row offset is a multiple of 16 bytes: only the bases can break
  // 16-byte alignment (a view at an odd offset)
  const bool vec = (((uintptr_t)k | (uintptr_t)v) & 15u) == 0;
  const double scale = 1.0 / sqrt((double)D);
  decode_kernel<T, D, R><<<dim3(Hk, nb > B ? nb : B), kThreads, C::smem,
                           stream>>>(
      q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, window, cap, scale,
      vec);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int occupancy_g(int G, int* blocks) {
  switch (G) {
    case 1: return occupancy<T, D, 1>(blocks);
    case 2: return occupancy<T, D, 2>(blocks);
    default: return occupancy<T, D, 0>(blocks);
  }
}

// a group of 1 or 2 on the CUDA cores, larger ones on the tensor cores
template <typename T, int D>
int dispatch(const T* q, const T* k, const T* v, const int* kv_len, T* o,
             float* ws, int* count, int B, int S, int Hk, int G, int nb,
             float cap, int window, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, cap, window, st);
    case 2: return launch<T, D, 2>(q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, cap, window, st);
    default: return launch<T, D, 0>(q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, cap, window, st);
  }
}

template <typename T>
int decode_entry(const void* q, const void* k, const void* v,
                 const void* kv_len, void* o, void* ws, void* count, int B,
                 int S, int H, int Hk, int D, int nb, float cap, int window,
                 void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || H / Hk > kRows || nb <= 0 ||
      nb > 65535 || B > 65535 ||
      (long long)B * Hk > 0x7fffffff ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 3u))
    return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const int* len = (const int*)kv_len;
  T* ot = (T*)o;
  float* wf = (float*)ws;
  int* cf = (int*)count;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return dispatch<T, 16>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 32: return dispatch<T, 32>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 64: return dispatch<T, 64>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 96: return dispatch<T, 96>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 128: return dispatch<T, 128>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 256: return dispatch<T, 256>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_entry(int D, int G, int* blocks) {
  if (G <= 0 || G > kRows) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return occupancy_g<T, 16>(G, blocks);
    case 32: return occupancy_g<T, 32>(G, blocks);
    case 64: return occupancy_g<T, 64>(G, blocks);
    case 96: return occupancy_g<T, 96>(G, blocks);
    case 128: return occupancy_g<T, 128>(G, blocks);
    case 256: return occupancy_g<T, 256>(G, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o (B, H, D), k/v (B, S, Hk, D) float32, kv_len (B,) int32, contiguous;
// ws a float32 scratch of Hk * max(nb, B) * (G*D + 2*G) (the split
// partials: acc (G, D) of every block, then m and l (G each)), count an
// int32 (B * Hk) of zeros (left zero after the launch).  nb the blocks of
// a kv head that the sequences share by their live keys; G = H / Hk at
// most 16.  cap <= 0 means no soft-cap, window <= 0 none.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* o, void* ws, void* count, int B,
                                    int S, int H, int Hk, int D, int nb,
                                    float cap, int window, void* stream) {
  return decode_entry<float>(q, k, v, kv_len, o, ws, count, B, S, H, Hk, D,
                             nb, cap, window, stream);
}

// How many blocks of the instance for (D, G) one SM holds at once (shared
// memory and registers), for the wrapper's grid rule.  No launch.
extern "C" int decode_attention_occupancy(int D, int G, int* blocks) {
  return occupancy_entry<float>(D, G, blocks);
}
