// decode_attention_bf16.cu: flash-decoding of one query token per sequence
// against its bf16 KV cache (decode_attention_bf16: the served LMs' bf16
// decode step), GQA, optional logit soft-cap and sliding window, with a
// per-sequence cache length; sums in fp32 (fp64 scores at groups 1-2), the
// output rounded to bf16 once.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// decode_attention_kernel (Pallas body _decode_kernel) and the logsumexp
// combine of its split partials (ops.py, combine_splits), on bf16 inputs.
// decode_attention.cu keeps the fp32 kernel.
//
// Layout: the model's own.  q/o (B, 1, H, D), k/v caches (B, S, Hk, D),
// kv_len (B,) int32, all contiguous; query head h = hk*G + g reads kv head
// hk.  Only the live keys are read: kpos < kv_len and, with a window,
// kpos >= kv_len - window.  Positions at or beyond kv_len are never read.
//
// Bound on an H100: bytes.  Each live key costs 2*D*2 bytes of K and V
// against 4*D operations per query head of its group, G operations per
// byte, far below the bf16 ridge (295).  chatglm3-6b's long decode tick
// (slots of 7, 23, 30 and 4206 keys, 2 kv heads of 128) reads 4.4 MB: 1.3
// us.  A tick is short, so what costs is latency: the launch, the plan,
// the first load, the chain of stages a block walks and the merges.
//
// Design: one launch of thread-block clusters of C blocks; a block is 8
// warps.
//  - The plan is the card's, from kv_len (no host sync): each kv head has
//    ncl clusters (the grid (ncl*C, Hk); the wrapper sizes nb, the blocks
//    of a kv head, to one wave of the card, and C and ncl follow from nb
//    and B: cluster_size; kernel.py bf16_grid mirrors it).  Every
//    sequence takes one cluster; the other ncl - B are shared over the
//    sequences in proportion to their live keys (at most one cluster per
//    C*kMinKeys keys), and a sequence's clusters hold equal splits of
//    whole 8-key groups, at least a stage, one a block (kernel.py
//    bf16_plan).  Cluster x < B is sequence x's first; the clusters from B
//    on are the others, sequence by sequence; a cluster past the plan
//    returns at once.  So a long tick's live keys cover the card in splits
//    of a stage or two, and a short slot is one cluster whose rank 0 works
//    alone (its other blocks return at once).
//  - Loads: every warp copies 8 rows (keys) of each 64-key stage, K and V
//    (D bf16 each, contiguous in the cache), with 16-byte cp.async into a
//    ring of 2-4 stages; rows at or past k_end are zero-filled by the copy
//    (source size 0), never read.  No producer warp, no mbarrier: per-key
//    bulk copies (cp.async.bulk on mbarriers) stream these rows 1.7-3x
//    slower than 16-byte cp.async (scripts/decode_loader_probe.py), and a
//    warp that waits only for its own copies needs no barrier.
//  - Compute, nearer float64 than the plain version's fp32 sums, each
//    warp in its own (m, l, O) in registers:
//     - G >= 3 (chatglm3-6b: 16): 4 warps of 16 keys a stage, bf16
//       mma.sync: Q.K^T as two n8 tiles of m16n8k16 over D (G rows padded
//       to 16; bf16 products are exact in fp32), P.V as m16n8k16 over the
//       16 keys on P's bf16 hi and lo parts, V's B operands by ldmatrix's
//       transposed load (bf16.cuh); a warp's rows are two warps' loads, so
//       the block waits together once a stage (a split is one or two).
//     - G 1-2 (gemma2-2b, phi3-mini, moonshot, seamless's cross decode):
//       8 warps of 8 keys on the CUDA cores, 4 lanes a key each summing a
//       quarter of D in fp64 (exact products), a warp's softmax by xor
//       shuffles, P*V in fp32 with lane l on head dims l, l+32, ...; a
//       warp computes on the rows it loaded: no block barrier in the key
//       loop past the first stage (q).
//  - Merge, in split order with fixed trees, so the bits do not depend on
//    which block finishes last: a block merges its warps in shared memory
//    (warp order).  In a cluster, each block with a split pushes its m
//    and l to every rank and its O, element by element, to the rank whose
//    slice of the G*D outputs holds it (stores to distributed shared
//    memory); after one cluster barrier rank r merges its slice over the
//    ranks in rank order.  A sequence of one cluster writes o there.
//    Otherwise each rank writes its slice of the cluster's one partial
//    (and the cluster's m, l of its rows) to the workspace, and its thread
//    0 bumps the counter of (b, hk, r) with a release; the rank that
//    brings it to the sequence's clusters merges slice r over them
//    (cluster order), writes o and resets the counter.  An empty warp,
//    block or split carries m = -1e30, l = 0, O = 0 (never -inf: no
//    exp(-inf - -inf) = NaN); a sequence with no live key gets zeros.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16mma::bf16;

constexpr int kGroup = 8;          // a split is whole groups of 8 keys
constexpr int kStage = 64;         // keys a stage
constexpr int kRows = 16;          // the mma's m16: G query rows, padded
constexpr int kMinKeys = kStage;   // a split's keys at least
constexpr int kMaxClusters = 64;   // a sequence's clusters at most
constexpr int kMaxCluster = 8;     // blocks a cluster at most (portable)
constexpr int kMaxWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// R = 0: the tensor-core route, G <= 16 rows padded to the mma's 16;
// R = G (1 or 2): fp64 scores on the CUDA cores
template <int D, int R>
struct Cfg {
  static constexpr bool kMma = R == 0;
  // a block is 8 warps, all of which load and merge; the warps that
  // compute and the keys each takes in a stage: the tensor-core route 4 of
  // 16 (two n8 tiles of S, m16n8k16 for P.V; half as many warps' O, 16 x D
  // fp32 each, to merge through shared memory), the CUDA cores 8 of 8
  static constexpr int kThreads = 32 * kMaxWarps;
  static constexpr int kWarps = kMma ? 4 : kMaxWarps;
  static constexpr int WK = kStage / kWarps;
  // K's, V's and q's row stride in shared memory (bf16): 16 bytes of
  // padding, for the 32-bit fragment loads of K and ldmatrix's 16-byte
  // rows of V; each row starts 16-byte aligned, as 16-byte copies want
  static constexpr int L = D + 8;
  static constexpr int MS = D + 8;          // the warps' merge rows (fp32)
  static constexpr int DK = D / 8;          // the mma's 8-wide d steps
  static constexpr int DT = (D + 31) / 32;  // CUDA cores: P*V dims a lane
  static constexpr int NRW = kMma ? kRows : R;  // rows of a state
  // stages in each warp's ring: a split is a stage or two at the long
  // tick's groups of 16; the CUDA-core route's splits are longer (many kv
  // heads share the card), so more in flight where shared memory leaves
  // two blocks an SM
  static constexpr int kStages = D >= 256 || kMma ? 2 : D >= 128 ? 3 : 4;
  static constexpr size_t q_bytes = sizeof(bf16) * NRW * L;
  static constexpr size_t stage = sizeof(bf16) * kStage * 2 * L;  // K, V
  // the ring, reused after the key loop for the warps' O
  static constexpr size_t merge = sizeof(float) * kWarps * NRW * MS;
  static constexpr size_t ring =
      kStages * stage > merge ? kStages * stage : merge;
  // the block's m and l [NRW] each (in 2 * kRows floats: the inbox starts
  // 16-byte aligned), then the inbox of its cluster's merge: each rank's m
  // and l, then each rank's O at this rank's slice
  static constexpr int kInbox = 2 * NRW * kMaxCluster + NRW * D + kMaxCluster;
  static constexpr size_t smem =
      q_bytes + ring + sizeof(float) * (2 * kRows + kInbox);
  // two blocks an SM (registers <= 128 a thread), but one where the group
  // of 16 at D 256 holds 128 accumulators a thread
  static constexpr int kMinBlocks = kMma && D >= 256 ? 1 : 2;
};

// the visible keys [lo, len) of a sequence whose cache holds kv keys
__device__ __forceinline__ int live_range(int kv, int S, int window,
                                          int& lo) {
  const int len = min(kv, S);
  lo = window > 0 ? max(0, kv - window) : 0;
  return len;
}

// clusters (n), keys a split (chunk) and splits (used) of a sequence of
// `live` keys, with `extra` clusters beyond one a sequence shared by
// sequences of `total` live keys, in clusters of `nc` blocks
__device__ __forceinline__ void plan(int live, int extra, long long total,
                                     int nc, int& n, int& chunk, int& used) {
  const int lnc = __ffs(nc) - 1;   // nc is a power of two
  const long long x = (long long)max(extra, 0) * live;
  // floor(extra * live / total), in 32 bits where both fit (the common
  // case: a 64-bit division is a long subroutine)
  n = 1 + (extra <= 0 || total <= 0 ? 0
           : x < 0x80000000LL && total < 0x80000000LL
               ? (int)((unsigned)x / (unsigned)total)
               : (int)(x / total));
  static_assert(kMinKeys == 64, "a shift by log2(kMinKeys)");
  n = max(1, min(n, min(kMaxClusters,
                        (live + nc * kMinKeys - 1) >> (6 + lnc))));
  chunk = (live + n * nc - 1) / (n * nc);
  chunk = max(kMinKeys, (chunk + kGroup - 1) / kGroup * kGroup);
  used = max(1, (live + chunk - 1) / chunk);
  n = (used + nc - 1) >> lnc;
}

// one 16-byte (4-byte) copy into shared memory, zeros without reading the
// source where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hopper::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   hopper::smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// old + 1 at *p, releasing the writes that happen before it (this block's,
// by its barrier) and acquiring those released before the old value
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

template <int D, int R>
__global__ void __launch_bounds__(Cfg<D, R>::kThreads, Cfg<D, R>::kMinBlocks)
decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ kv_len,
                   bf16* __restrict__ o, float* __restrict__ ws,
                   int* __restrict__ count, int B, int S, int Hk, int G,
                   int window, float cap, double scale) {
  using C = Cfg<D, R>;
  constexpr int L = C::L, MS = C::MS, DK = C::DK, DT = C::DT;
  constexpr int NS = C::kStages, NRW = C::NRW, NW = C::kWarps;
  constexpr int T = C::kThreads, WK = C::WK;
  constexpr int LR = kStage / kMaxWarps;   // rows a warp loads a stage
  // per thread: rows tracked, accumulator groups and their width (mma:
  // fragment rows gq and gq+8, D/8 tiles of 4; CUDA cores: R rows, dims
  // lane + 32t)
  constexpr int NR = C::kMma ? 2 : R;
  constexpr int NA = C::kMma ? DK : DT;
  constexpr int NE = C::kMma ? 4 : R;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);               // [NRW][L]
  unsigned char* ring = smem + C::q_bytes;
  float* st = reinterpret_cast<float*>(ring + C::ring);    // m, l [NRW]
  float* inbox = st + 2 * kRows;                           // [C::kInbox]
  __shared__ float m_s[NW][NRW], l_s[NW][NRW];
  __shared__ float p_s[NW][8][2];  // CUDA cores: P of a warp's 8 keys
  __shared__ int last_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // mma: fragment row and column group; CUDA cores: key and quarter of D
  const int gq = lane >> 2, tq = lane & 3;
  const int hk = blockIdx.y;
  const int xcl = blockIdx.x / nc;   // the cluster's slot of kv head hk
  const int ncl = gridDim.x / nc;

  // the plan (kernel.py bf16_plan), computed alike by every warp with one
  // sequence a lane, 32 at a time (the first 32 read once): this cluster's
  // sequence b and its place ci among b's clusters, b's clusters, splits
  // and their size, and `first`, where b's clusters past the first start
  // among those from B on
  long long total = 0;
  int len0 = 0, lo0 = 0;
  for (int c = 0; c < B; c += 32) {
    int lo_i = 0;
    const int len_i =
        c + lane < B ? live_range(kv_len[c + lane], S, window, lo_i) : 0;
    if (c == 0) {
      len0 = len_i;
      lo0 = lo_i;
    }
    long long t = max(len_i - lo_i, 0);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) t += __shfl_xor_sync(kFull, t, w);
    total += t;
  }
  int b = -1, ci = 0, ncs = 1, chunk = kGroup, used = 1, first = 0, lo = 0,
      len = 0;
  for (int c = 0, off = 0; c < B; c += 32) {
    const int i = c + lane;
    int lo_i = lo0, len_i = len0, n = 1, ch = kGroup, u = 1;
    if (i < B) {
      if (c > 0) len_i = live_range(kv_len[i], S, window, lo_i);
      plan(max(len_i - lo_i, 0), ncl - B, total, nc, n, ch, u);
    }
    // the clusters past the first of the sequences before i: a scan
    const int own = i < B ? n - 1 : 0;
    int incl = own;
#pragma unroll
    for (int w = 1; w < 32; w <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, w);
      if (lane >= w) incl += x;
    }
    const int excl = off + incl - own;
    const int e = xcl - B - excl;    // xcl's place among i's other clusters
    const unsigned hit = __ballot_sync(
        kFull, i < B && (xcl == i || (xcl >= B && e >= 0 && e < n - 1)));
    if (hit) {
      const int src = __ffs(hit) - 1;
      b = c + src;
      ncs = __shfl_sync(kFull, n, src);
      chunk = __shfl_sync(kFull, ch, src);
      used = __shfl_sync(kFull, u, src);
      first = __shfl_sync(kFull, excl, src);
      lo = __shfl_sync(kFull, lo_i, src);
      len = __shfl_sync(kFull, len_i, src);
      ci = xcl == b ? 0 : xcl - B - first + 1;
    }
    off += __shfl_sync(kFull, incl, 31);
  }
  if (b < 0) return;   // past the plan: the whole cluster

  const int si = ci * nc + rank;             // this block's split of b
  const int ncu = min(nc, used - ci * nc);   // the cluster's ranks with one
  // a sequence of one split (a short slot): rank 0 writes o alone, the
  // cluster's other blocks leave now (no cluster barrier follows)
  const bool alone = ncs == 1 && ncu == 1;
  if (alone && rank > 0) return;
  int k_beg = 0, k_end = 0;
  if (si < used) {
    k_beg = lo + si * chunk;
    k_end = min(len, k_beg + chunk);
  }
  const int nst = k_end > k_beg ? (k_end - k_beg + kStage - 1) / kStage : 0;
  // the warps with keys (all where a split has two stages or more); the
  // others' O is 0 and is left out of the merge
  const int nwa = nst > 1 ? NW : (max(k_end - k_beg, 0) + WK - 1) / WK;
  const int H = Hk * G;
  const size_t row = (size_t)Hk * D;     // stride between positions
  const size_t base = ((size_t)b * S * Hk + hk) * D;
  auto stage_at = [&](int t) {
    return reinterpret_cast<bf16*>(ring + (size_t)(t % NS) * C::stage);
  };
  // this warp's LR rows of K and V of stage t, by 16-byte cp.async over
  // the warp's lanes; rows at or past k_end are zero-filled, not read
  // (all of a computing warp's WK rows are written, or none: P.V reads
  // them, 0 times their values)
  auto load = [&](int t) {
    const int j0 = k_beg + t * kStage + warp * LR;
    if (t >= nst || k_beg + t * kStage + warp * LR / WK * WK >= k_end) return;
    bf16* ks = stage_at(t) + warp * LR * L;
    bf16* vs = stage_at(t) + (kStage + warp * LR) * L;
    constexpr int kChunks = D / 8;     // 16-byte chunks a row
#pragma unroll 4
    for (int e = lane; e < LR * kChunks; e += 32) {
      const int j = e / kChunks, c = (e % kChunks) * 8;
      const bool ok = j0 + j < k_end;
      const size_t off = ok ? base + (size_t)(j0 + j) * row + c : base;
      cp_async16(ks + j * L + c, k + off, ok);
      cp_async16(vs + j * L + c, v + off, ok);
    }
  };

  // q (rows past G zero), then the first NS - 1 stages: one commit group a
  // stage, q in the first
  const bf16* qb = q + ((size_t)b * H + hk * G) * D;
  if (nst > 0 && ((uintptr_t)qb & 15) == 0) {
    for (int e = tid; e < NRW * D / 8; e += T) {
      const int r = 8 * e / D, d = 8 * e % D;
      cp_async16(q_s + r * L + d, r < G ? qb + 8 * e : qb, r < G);
    }
  } else if (nst > 0) {
    for (int e = tid; e < NRW * D / 2; e += T) {
      const int r = 2 * e / D, d = 2 * e % D;
      cp_async4(q_s + r * L + d, r < G ? qb + 2 * e : qb, r < G);
    }
  }
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    load(t);
    cp_commit();
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

  // the key loop: a warp computes on the rows it loaded itself, so it
  // waits for its own copies only (the whole block once, for q); on the
  // tensor-core route a computing warp's 16 rows are two warps' loads, so
  // the block waits together, once a stage (a split there is a stage or
  // two)
  for (int s = 0; s < nst; ++s) {
    cp_wait<NS - 2>();     // this thread's copies of stage s (and q)
    if (s == 0 || NW < kMaxWarps)
      __syncthreads();     // q and stage s, from every thread
    else
      __syncwarp();        // the warp's rows of stage s; stage s-1's free
    load(s + NS - 1);
    cp_commit();
    const int j0 = k_beg + s * kStage + warp * WK;  // the warp's keys
    const bf16* ks = stage_at(s) + warp * WK * L;
    const bf16* vs = stage_at(s) + (kStage + warp * WK) * L;
    if (warp >= NW || j0 >= k_end) continue;
    if constexpr (C::kMma) {
      using namespace bf16mma;
      // S = Q.K^T on the warp's 16 keys (two n8 tiles), one m16n8k16 bf16
      // term a 16-wide d step (bf16 products are exact in fp32)
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const bf16* qa = q_s + gq * L + 2 * tq;
      const bf16* kr = ks + gq * L + 2 * tq;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        const uint32_t a[4] = {ld32(qa + d0), ld32(qa + 8 * L + d0),
                               ld32(qa + d0 + 8), ld32(qa + 8 * L + d0 + 8)};
        mma16(sc[0], a, ld32(kr + d0), ld32(kr + d0 + 8));
        mma16(sc[1], a, ld32(kr + 8 * L + d0), ld32(kr + 8 * L + d0 + 8));
      }
      // scale, cap, mask; sc[t][e] is row gq + 8*(e>>1), key 8t + 2*tq +
      // (e&1) of the warp's 16
      bool ok[2][4];
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = sc[t][e] * (float)scale;
          if (cap > 0.0f) x = cap * tanhf(x / cap);
          ok[t][e] = gq + 8 * i < G && j0 + 8 * t + 2 * tq + (e & 1) < k_end;
          sc[t][e] = ok[t][e] ? x : kNegInf;
          tmax[i] = fmaxf(tmax[i], sc[t][e]);
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
      // P (16 rows x the warp's 16 keys) as the m16n8k16 A operand, in a
      // bf16 hi and lo part: tile t's rows gq and gq+8 are its registers
      // 2t and 2t+1
      float p[2][4];
      float rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[t][e] = ok[t][e] ? expf(sc[t][e] - m[e >> 1]) : 0.0f;
          rsum[e >> 1] += p[t][e];
        }
      uint32_t phi[4], plo[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        pack_split(p[t][0], p[t][1], phi[2 * t], plo[2 * t]);
        pack_split(p[t][2], p[t][3], phi[2 * t + 1], plo[2 * t + 1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
      // P.V: V's B operands two d tiles at a time by ldmatrix x4 (lanes
      // 0-15 give the warp's 16 keys at d tile dt, lanes 16-31 at dt+1);
      // per d tile a fresh accumulator, added to O with an fp32 add.  A
      // key past k_end has p = 0 and v = 0 (zero-filled): it adds exactly 0
      const bf16* vr = vs + (lane & 15) * L + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DK; dt += 2) {
        uint32_t r[4];
        ldsm4t(r, vr + dt * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma16(tb, plo, r[2 * h], r[2 * h + 1]);
          mma16(tb, phi, r[2 * h], r[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[dt + h][e] = fmaf(acc[dt + h][e], alpha[e >> 1], tb[e]);
        }
      }
    } else {
      // scores: lane (gq, tq) takes key gq of the warp's 8 and d = 16c +
      // 4tq .. +3, in fp64 (two chains over c; exact products), then two
      // xor shuffles
      double dot[R][2];
#pragma unroll
      for (int g = 0; g < R; ++g) dot[g][0] = dot[g][1] = 0.0;
      const bf16* kr = ks + gq * L + 4 * tq;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        double kd[4];
        {
          const uint2 raw = *reinterpret_cast<const uint2*>(kr + 16 * c);
          const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(
              &raw.x);
          const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(
              &raw.y);
          kd[0] = __bfloat162float(a.x);
          kd[1] = __bfloat162float(a.y);
          kd[2] = __bfloat162float(b2.x);
          kd[3] = __bfloat162float(b2.y);
        }
#pragma unroll
        for (int g = 0; g < R; ++g) {
          const uint2 raw =
              *reinterpret_cast<const uint2*>(q_s + g * L + 16 * c + 4 * tq);
          const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(
              &raw.x);
          const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(
              &raw.y);
          double x = fma((double)__bfloat162float(a.x), kd[0], dot[g][c & 1]);
          x = fma((double)__bfloat162float(a.y), kd[1], x);
          x = fma((double)__bfloat162float(b2.x), kd[2], x);
          dot[g][c & 1] = fma((double)__bfloat162float(b2.y), kd[3], x);
        }
      }
      const bool ok = j0 + gq < k_end;
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
        const float pv = ok ? expf(x - m_new) : 0.0f;
        float ps = pv + __shfl_xor_sync(kFull, pv, 4);
        ps += __shfl_xor_sync(kFull, ps, 8);
        ps += __shfl_xor_sync(kFull, ps, 16);
        l[g] = l[g] * alpha + ps;
        m[g] = m_new;
#pragma unroll
        for (int u = 0; u < DT; ++u) acc[u][g] *= alpha;
        if (tq == g) p_s[warp][gq][g] = pv;
      }
      __syncwarp();
      // P*V over the warp's 8 keys in order, lane l on dims l, l+32, ...;
      // a key past k_end has p = 0 and v = 0 (zero-filled): it adds 0
#pragma unroll 2
      for (int u = 0; u < 8; ++u) {
        const bf16* vr = vs + u * L;
        float vv[DT];
#pragma unroll
        for (int t2 = 0; t2 < DT; ++t2) {
          const int d = lane + 32 * t2;
          vv[t2] = d < D ? __bfloat162float(vr[d]) : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < R; ++g) {
          const float pv = p_s[warp][u][g];
#pragma unroll
          for (int t2 = 0; t2 < DT; ++t2)
            acc[t2][g] = fmaf(pv, vv[t2], acc[t2][g]);
        }
      }
    }
  }
  cp_wait<0>();

  // the warps' states, merged in warp order: each warp's O weighted by
  // exp(m_w - m_b) into the ring (rows padded: 2-way bank conflicts at
  // most), m_b and l_b a row into st
  if (warp >= NW) {
  } else if constexpr (C::kMma) {
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
  __syncthreads();   // every warp's keys done: the ring is free
  float* mrg_s = reinterpret_cast<float*>(ring);   // [NW][NRW][MS]
  if (warp >= nwa) {
  } else if constexpr (C::kMma) {
    float wt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mb = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mb = fmaxf(mb, m_s[w][gq + 8 * i]);
      wt[i] = expf(m[i] - mb);
    }
#pragma unroll
    for (int dt = 0; dt < DK; ++dt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            mrg_s + (warp * NRW + gq + 8 * i) * MS + dt * 8 + 2 * tq) =
            make_float2(acc[dt][2 * i] * wt[i], acc[dt][2 * i + 1] * wt[i]);
  } else {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      float mb = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mb = fmaxf(mb, m_s[w][g]);
      const float wt = expf(m[g] - mb);
#pragma unroll
      for (int t2 = 0; t2 < DT; ++t2) {
        const int d = lane + 32 * t2;
        if (d < D) mrg_s[(warp * NRW + g) * MS + d] = acc[t2][g] * wt;
      }
    }
  }
  if (tid < G) {
    float mb = kNegInf, lb = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, m_s[w][tid]);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      lb += l_s[w][tid] * expf(m_s[w][tid] - mb);
    st[tid] = mb;
    st[NRW + tid] = lb;
  }
  __syncthreads();

  const int E = G * D;
  bf16* ob = o + ((size_t)b * H + hk * G) * D;
  // a sequence of several clusters: the cluster's partial in its slot of
  // the workspace ([E] O, then each rank's copy of m and l [G] each, of
  // the rows of its slice)
  const int per = E + 2 * G * nc;
  float* part = ws + ((size_t)hk * ncl + xcl) * per;
  float* ml = part + E + rank * 2 * G;
  // this rank's slice [e0, e1) of the G*D outputs
  const int sl = (E + nc - 1) / nc;
  const int e0 = rank * sl, e1 = min(E, e0 + sl);
  if (nc == 1 || alone) {
    // the block is its cluster: O summed over the warps straight to o, or
    // to the partial
    for (int e = tid; e < E; e += T) {
      const int g = e / D, d = e - g * D;
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        if (w < nwa) a += mrg_s[(w * NRW + g) * MS + d];
      if (ncs == 1)
        ob[e] = __float2bfloat16_rn(a * (1.0f / fmaxf(st[NRW + g], 1e-30f)));
      else
        part[e] = a;
    }
    if (ncs > 1 && tid < G) {
      ml[tid] = st[tid];
      ml[G + tid] = st[NRW + tid];
    }
  } else {
    // the cluster's merge: a block with a split pushes its m and l to
    // every rank's inbox and its O, summed over the warps, element by
    // element to the inbox of the rank whose slice holds it (stores to
    // distributed shared memory); after the barrier each rank merges its
    // slice from its own inbox, over the ranks with a split in rank order,
    // in one pass
    if (si < used) {
      for (int i = tid; i < nc * G; i += T) {
        const int r = i / G, g = i - r * G;
        float* dst = cluster.map_shared_rank(inbox, r) + rank * 2 * NRW;
        dst[g] = st[g];
        dst[NRW + g] = st[NRW + g];
      }
      // 16-byte stores where the slices are whole float4s (a row is; the
      // merge rows start 16-byte aligned), spread so that each thread
      // issues few (a remote store waits out its round trip)
      const int vw = sl % 4 == 0 ? 4 : 1;
      for (int i = tid; i < E / vw; i += T) {
        const int e = i * vw, g = e / D, d = e - g * D, r = e / sl;
        float* dst = cluster.map_shared_rank(inbox, r) +
                     2 * NRW * kMaxCluster + (rank - r) * sl + e;
        if (vw == 4) {
          float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (w < nwa) {
              const float4 x =
                  *reinterpret_cast<const float4*>(mrg_s + (w * NRW + g) * MS + d);
              a.x += x.x;
              a.y += x.y;
              a.z += x.z;
              a.w += x.w;
            }
          *reinterpret_cast<float4*>(dst) = a;
        } else {
          float a = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (w < nwa) a += mrg_s[(w * NRW + g) * MS + d];
          *dst = a;
        }
      }
    }
    hopper::cluster_arrive();
    hopper::cluster_wait();
    const float* in_o = inbox + 2 * NRW * kMaxCluster - e0;
    for (int e = e0 + tid; e < e1; e += T) {
      const int g = e / D;
      float mx = kNegInf, den = 0.0f, num = 0.0f;
#pragma unroll
      for (int u = 0; u < kMaxCluster; ++u)
        if (u < ncu) mx = fmaxf(mx, inbox[u * 2 * NRW + g]);
#pragma unroll
      for (int u = 0; u < kMaxCluster; ++u) {
        if (u < ncu) {
          const float w = expf(inbox[u * 2 * NRW + g] - mx);
          den = fmaf(inbox[u * 2 * NRW + NRW + g], w, den);
          num = fmaf(in_o[u * sl + e], w, num);
        }
      }
      if (ncs == 1) {
        ob[e] = __float2bfloat16_rn(num * (1.0f / fmaxf(den, 1e-30f)));
      } else {
        part[e] = num;
        if (e == e0 || e == g * D) {   // the row's first element here
          ml[g] = mx;
          ml[G + g] = den;
        }
      }
    }
  }

  if (ncs > 1) {
    // the partial written: thread 0's release (after the barrier) bumps
    // the counter of (b, hk, rank); the block that brings it to ncs merges
    // slice r of the ncs partials, in cluster order: each element's loads
    // of every partial (up to kBatch at once) before its sums (L2 reads:
    // other SMs wrote them)
    __syncthreads();
    int* cnt = count + ((size_t)b * Hk + hk) * nc + rank;
    if (tid == 0) last_s = add_acq_rel(cnt) == ncs - 1;
    __syncthreads();
    if (last_s) {
      constexpr int kBatch = 16;
      for (int e = e0 + tid; e < e1; e += T) {
        const int g = e / D;
        float mx = kNegInf, den = 0.0f, num = 0.0f;
        for (int c0 = 0; c0 < ncs; c0 += kBatch) {
          float mc[kBatch], lc[kBatch], ac[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            mc[u] = kNegInf;
            lc[u] = ac[u] = 0.0f;
            const int c = c0 + u;
            if (c < ncs) {
              const float* pc =
                  ws + ((size_t)hk * ncl + (c == 0 ? b : B + first + c - 1)) *
                           per;
              mc[u] = __ldcg(pc + E + rank * 2 * G + g);
              lc[u] = __ldcg(pc + E + rank * 2 * G + G + g);
              ac[u] = __ldcg(pc + e);
            }
          }
          // the batch's max, then its terms (independent exponentials)
          // added in cluster order; an earlier batch's sums rescaled
          float mn = mx;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) mn = fmaxf(mn, mc[u]);
          const float s0 = expf(mx - mn);
          den *= s0;
          num *= s0;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const float w = expf(mc[u] - mn);
            den = fmaf(lc[u], w, den);
            num = fmaf(ac[u], w, num);
          }
          mx = mn;
        }
        ob[e] = __float2bfloat16_rn(num * (1.0f / fmaxf(den, 1e-30f)));
      }
      if (tid == 0) *cnt = 0;             // ready for the next call
    }
  }
}

// the cluster size for B sequences sharing nb blocks of a kv head: the
// largest whose B first clusters (one a sequence) take at most a third of
// the budget (kernel.py bf16_grid)
int cluster_size(int B, int nb) {
  for (int c = kMaxCluster; c > 1; c /= 2)
    if (3LL * B * c <= nb) return c;
  return 1;
}

}  // namespace


namespace {

template <int D, int R>
cudaLaunchConfig_t config(int grid_x, int Hk, int nc, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid_x, (unsigned)Hk);
  cfg.blockDim = dim3(Cfg<D, R>::kThreads);
  cfg.dynamicSmemBytes = Cfg<D, R>::smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a cluster's blocks on as many SMs as are free, not packed on one
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = nc > 1 ? 2 : 0;
  return cfg;
}

template <int D, int R>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(decode_bf16_kernel<D, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Cfg<D, R>::smem);
}

template <int D, int R>
int occupancy(int nc, int* out) {
  cudaError_t e = opt_in<D, R>();
  if (e != cudaSuccess) return (int)e;
  if (nc == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, decode_bf16_kernel<D, R>, Cfg<D, R>::kThreads, Cfg<D, R>::smem);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = config<D, R>(nc, 1, nc, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, decode_bf16_kernel<D, R>,
                                             &cfg);
}

template <int D, int R>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len,
           bf16* o, float* ws, int* count, int B, int S, int Hk, int G,
           int nb, float cap, int window, cudaStream_t st) {
  cudaError_t e = opt_in<D, R>();
  if (e != cudaSuccess) return (int)e;
  const int nc = cluster_size(B, nb);
  const long long ncl = B > nb / nc ? B : nb / nc;
  if (ncl * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      config<D, R>((int)(ncl * nc), Hk, nc, st, attr);
  e = cudaLaunchKernelEx(&cfg, decode_bf16_kernel<D, R>, q, k, v, kv_len, o,
                         ws, count, B, S, Hk, G, window, cap,
                         1.0 / sqrt((double)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// a group of 1 or 2 on the CUDA cores, larger ones on the tensor cores
template <int D>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len,
             bf16* o, float* ws, int* count, int B, int S, int Hk, int G,
             int nb, float cap, int window, cudaStream_t st) {
  switch (G) {
    case 1: return launch<D, 1>(q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, cap, window, st);
    case 2: return launch<D, 2>(q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, cap, window, st);
    default: return launch<D, 0>(q, k, v, kv_len, o, ws, count, B, S, Hk, G, nb, cap, window, st);
  }
}

template <int D>
int occupancy_g(int G, int nc, int* out) {
  switch (G) {
    case 1: return occupancy<D, 1>(nc, out);
    case 2: return occupancy<D, 2>(nc, out);
    default: return occupancy<D, 0>(nc, out);
  }
}

}  // namespace

// q/o (B, H, D), k/v (B, S, Hk, D) bf16, kv_len (B,) int32, contiguous; k
// and v 16-byte aligned (16-byte copies), q and o 4-byte.  nb the blocks of a
// kv head the sequences share (the wrapper's bf16_blocks): clusters of
// C = cluster_size(B, nb) blocks, max(B, nb / C) of them a kv head.  ws a
// float32 scratch of Hk * max(B, nb / C) * (G*D + 2*G*C), count an int32
// (B * Hk * C) of zeros (left zero after the launch).  G = H / Hk at most
// 16.  cap <= 0 means no soft-cap, window <= 0 none.  A launch the card
// refuses (the cluster's blocks do not fit an SM's group) returns its
// error.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* o, void* ws, void* count, int B,
                                     int S, int H, int Hk, int D, int nb,
                                     float cap, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || Hk > 65535 || H % Hk ||
      H / Hk > kRows || nb <= 0 ||
      (((uintptr_t)q | (uintptr_t)o) & 3u) ||
      (((uintptr_t)k | (uintptr_t)v) & 15u))
    return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const bf16* qt = (const bf16*)q;
  const bf16* kt = (const bf16*)k;
  const bf16* vt = (const bf16*)v;
  const int* len = (const int*)kv_len;
  bf16* ot = (bf16*)o;
  float* wf = (float*)ws;
  int* cf = (int*)count;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return dispatch<16>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 32: return dispatch<32>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 64: return dispatch<64>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 96: return dispatch<96>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 128: return dispatch<128>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    case 256: return dispatch<256>(qt, kt, vt, len, ot, wf, cf, B, S, Hk, G, nb, cap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// For the instance of (D, G): with nc 1 the blocks one SM holds at once,
// else the clusters of nc blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), for the wrapper's budget.  No launch.
extern "C" int decode_attention_bf16_occupancy(int D, int G, int nc,
                                               int* out) {
  if (G <= 0 || G > kRows || (nc != 1 && nc != 2 && nc != 4 && nc != 8))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return occupancy_g<16>(G, nc, out);
    case 32: return occupancy_g<32>(G, nc, out);
    case 64: return occupancy_g<64>(G, nc, out);
    case 96: return occupancy_g<96>(G, nc, out);
    case 128: return occupancy_g<128>(G, nc, out);
    case 256: return occupancy_g<256>(G, nc, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
