// ssd_scan_bwd.cu: the gradient of ssd_scan.cu's within-chunk terms, fp32.
//
// Replaces no Pallas kernel: the JAX package differentiates its plain jnp
// SSD (models/ssm.py, _ssd_chunked) with jax.grad, so the gradient of the
// kernel at src/repro/kernels/ssd_scan/kernel.py:55 has no TPU kernel of
// its own.  The port trains its Mamba2 layers (mamba2-130m, jamba's) through
// kernels/ssd_scan/ops.py::SSDScanFn, whose backward calls this.
//
// Per (chunk bc, head h), group g = h / (H / G), with L_ij = exp(cs_i -
// cs_j) for i >= j (0 above the diagonal, where nothing is exponentiated),
// CB_ij = C_i . B_j, W_ij = CB_ij L_ij dt_j, e_j = exp(cs_{Q-1} - cs_j) and
// w_j = e_j dt_j, given dy (Q, P) and ds (N, P), the gradients of
//   y_diag[i, p] = sum_{j <= i} W_ij x[j, p]
//   s_local[n, p] = sum_j B[j, n] w_j x[j, p]
// are, with dM_ij = dy_i . x_j, T_ij = dM_ij CB_ij L_ij, V_j = B_j ds (P),
// E_j = ds x_j (N) and u_j = V_j . x_j = B_j . E_j:
//   dx_j  = sum_i W_ij dy_i + w_j V_j
//   dC_i  = sum_j S_ij B_j,  S_ij = sum_h dM_ij L_ij dt_j    (the group's
//   dB_j  = sum_i S_ij C_i + sum_h w_j E_j                     heads)
//   ddt_j = sum_i T_ij + e_j u_j
//   dcs_k = sum_j T_kj dt_j - dt_k sum_i T_ik - w_k u_k
//           (+ sum_j w_j u_j at k = Q-1)
// B and C are shared by a group's heads, so dB and dC need only the
// head-summed S: one product each per group, not one per head.
// Layout (the forward's): x, dy, dx (BC, H, Q, P); B, C, dB, dC (BC, G, Q,
// N); cs, dt, dcs, ddt (BC, H, 1, Q); ds (BC, H, N, P).
//
// Bound on an H100: operations.  At mamba2-130m's training micro-batch
// (8 chunks of Q 256, 24 heads in one group, N 128, P 64) the products need
// 3.4 GFLOP (C.B^T once a group, dy.x^T and W^T.dy per head, S against B
// and C once a group, B.ds and ds.x^T per head): 21 us at 3xTF32 (a third
// of the TF32 rate), against 48 MB moved (14 us).
//
// What held the first kernel (a block a (chunk, head, 32-row tile), column
// blocks for dx, dB, ddt, row blocks for dC) at ~35x that bound:
// 11.6 GFLOP of products for 3.4 needed, since every tile pair computed
// C.B^T twice (column and row block) for every head, dy.x^T twice, and each
// head's own dB and dC (a 25 MB partial each at mamba2, summed by a second
// launch); a block split each A element again for every output column tile
// that read it; tiles loaded behind a barrier with nothing in flight.
//
// Design: one or two launches, every sum in a fixed order with no atomics,
// so a call repeats the last one bit for bit.
//  1. ssd_bwd_main: a block owns a (chunk, group, split of the group's
//     heads, key tile j); split sp takes heads sp hg / splits .. (sp+1) hg /
//     splits - 1, and the host plan (kernels/ssd_scan/kernel.py::bwd_plan)
//     takes the fewest splits that fill the card two blocks an SM.  Key
//     tile 0 (nt row tiles to walk) is launched first and tile nt-1 (one)
//     last, so the card deals the heaviest blocks out first and the light
//     ones fill the tail (pairing tiles t and nt-1-t in one block measured
//     within 1.5% and was dropped).  The block holds B_j and, per head, x_j,
//     dx_j's sum and its per-key vectors in shared memory, and walks the row
//     tiles i >= j: C.B^T of the pair once for all its heads (64 state dims
//     a step), then per head in head order dM = dy_i.x_j^T, L, W and T in
//     registers (the fragments of dM and C.B^T coincide), S_ij += dM L dt
//     (registers, head order), dx_j += W^T dy_i (W through shared memory,
//     split as written), T's column sums (ddt and dcs's column terms) and T
//     dt's row sums (one partial per key tile, to scratch, for dcs's row
//     terms); after its heads the pair's S_ij (the lower triangle's tiles
//     only) goes to scratch.  Then per 32 state dims, per head: E_j = x_j
//     ds^T into the split's dB partial (w_j E_j, summed over its heads in
//     registers), u_j += B_j . E_j, dx_j += w_j (B_j ds).
//  2. The sums, in tasks: dC_t = sum_{j <= t} S_tj B_j, or dB_t = sum_{i >=
//     t} S_it^T C_i + the splits' w E partials, over a range of N; S the
//     splits' tiles summed in split order, each tile pair's product in a
//     fresh accumulator added with fp32 adds; the next pair's B or C rows
//     and S loads in flight while a pair is multiplied.  dC_t's chain is t+1
//     pairs and dB_t's nt-t, so the two are tasks of their own.  dcs's row
//     partials are added in key-tile order (and at Q-1 the s_local terms'
//     sum) to its column terms while a task's first loads are in flight.
//     Where a chunk and group's splits x nt blocks fit a cluster (at most
//     8), the launch is of clusters and its blocks, once all have arrived at
//     the cluster barrier, share out the tasks (ranges of at most 32 state
//     dims) and each finishes dcs for its own heads and tile: small shapes
//     are near launch-bound, and a second launch cost its start and a gap.
//     Else ssd_bwd_sums, a second launch, takes a task a block.
//  The first launch is compiled for 1, 2 or 4 column tiles of P a warp
//  (P <= 32, 64, 128), with the sums or without.
// Sums run in levels (a pair's product, then the pairs; a split's heads,
// then the splits): one fp32 chain of G x S terms was 6.2x farther from
// float64 than the plain autograd in flash_attention_bwd.cu.
// Term counts at mamba2's micro-batch (8 splits of 3 heads): C.B^T 36
// pairs x 8 splits (0.60 GFLOP), dy.x^T and W^T.dy 36 pairs x 24 heads
// (1.81), B.ds and ds.x^T 8 key tiles x 24 heads (1.61), S against B and
// C 36 pairs once (0.15): 4.2 GFLOP of products, the first kernel's 11.6.
// Every product runs on the tensor cores, TF32 mma.sync.m16n8k8 (tf32.cuh)
// in 3xTF32 (hi*hi + hi*lo + lo*hi), hi*hi of each 8-wide k step in a
// fresh accumulator added with fp32 adds, the cross terms summed beside it
// (the first kernel's arithmetic).  A warp owns 16 rows of an output and
// its column tiles, so it splits each A element once a k step for all of
// them.  Streamed tiles (C_i's 64-wide slices, dy_i with its cs, ds's 32
// rows) run through a ring of cp.async stages, four where they leave two
// blocks an SM (three steps in flight), else three or two; B_j, x_j and
// the key vectors land with the first step.  Operands are split into TF32
// parts as they are read (W once, as it is written): a ring of tiles split
// into two planes as they landed fit two stages in the same memory, and its
// first launch waited on the next tile.  Rows are
// padded by 4 floats, so fragment reads are free of bank conflicts.  Shared
// memory (Layout) depends on P, N and the heads a split: 109,184 bytes at
// mamba2 (3 heads, three stages), two blocks an SM.
// Any Q up to 256: rows and keys past Q are zero-filled and masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using namespace tf32;

constexpr int kThreads = 256;
constexpr int kT = 32;          // rows (and keys) of a tile
constexpr int kCB = 64;         // state dims of a C.B^T step
constexpr int kSL = 32;         // state dims of an s_local step
constexpr int kLT = kT + 4;     // row stride of a 32-wide tile (floats)
constexpr int kLC = kCB + 4;    // row stride of C's 64-wide slice
constexpr int kHV = 10;         // vectors of 32 a head
constexpr int kMaxT = 4;        // 16x8 tiles a warp sums in the second launch
constexpr int kLM = 128 + 4;    // row stride of the second launch's B or C
constexpr int kBatch = 8;       // splits' S loads in flight in the sums
constexpr int kDbBatch = 4;     // splits' w E partials in flight in the sums
                                // (half of each in the first launch's)
constexpr int kSumsFloats = 2 * kT * kLT + 2 * kT * kLM;   // the sums' smem
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable most)
constexpr int kMaxStages = 4;
constexpr int kSmemBlock = 232448;
constexpr int kTwoBlocks = 233472 / 2 - 1024;   // two blocks an SM
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The first launch's shared memory, in floats (kernel.py::bwd_smem mirrors
// it): a ring of ns stages of SF floats (C_i's 64-wide slice, dy_i's rows,
// or ds's 32 rows); the stages' cs of the rows; W in two planes; T dt's
// row sums by column group; B_j; and per head x_j, dx_j's sum and ten
// vectors of 32 (cs_j, dt_j, e_j, w_j, T's column sums by row half, u_j by
// column group)
struct Layout {
  int ns, PK, LP, LB, SF, vec, w, rowp, hb, hx, hdx, hv, total;
  __host__ __device__ Layout(int P, int N, int hs, int stages) {
    ns = stages;
    PK = round8(P);
    LP = PK + 4;
    LB = round8(N) + 4;
    SF = kT * imax(kLC, LP);
    vec = ns * SF;
    w = vec + ns * kT;
    rowp = w + 2 * kT * kLT;
    hb = rowp + 4 * kT;
    hx = hb + kT * LB;
    hdx = hx + hs * kT * LP;
    hv = hdx + hs * kT * LP;
    total = hv + hs * kHV * kT;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)total;
  }
};

// the ring's stages at P, N with hs heads a split: the most (up to four,
// so that three steps are in flight) that leave two blocks an SM, else two
__host__ __device__ inline int stages(int P, int N, int hs) {
  for (int ns = kMaxStages; ns > 2; --ns)
    if (Layout(P, N, hs, ns).bytes() <= (size_t)kTwoBlocks) return ns;
  return 2;
}

struct Args {
  const float* x;
  const float* bm;
  const float* cm;
  const float* cs;
  const float* dt;
  const float* dy;
  const float* ds;
  float* dx;
  float* db;
  float* dc;
  float* dcs;
  float* ddt;
  float* spart;    // (splits, BC G, pairs, 32, 32) each split's S tiles
  float* dbpart;   // (splits, BC G, Q, N) each split's w E sums
  float* rowpart;  // (BC, H, Q, nt) T dt's row sums by key tile
  float* esum;     // (BC, H, nt) w u's sums by key tile
  int BC, H, G, Q, P, N, NK, nt, splits, parts;
  bool vec;
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// acc[j] += A.B over k < K (a multiple of 8) for output tiles j < nj: A's
// fragment of each 8-wide k step from fa(k0, hi, lo), split once for all
// tiles, B's of tile j from fb(j, k0, bh0, bh1, bl0, bl1).  3xTF32: hi*hi
// of each k step in a fresh accumulator added to acc, the cross terms
// summed in accx
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mm(int K, int nj, FA fa, FB fb,
                                        float (&acc)[NT][4],
                                        float (&accx)[NT][4]) {
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    fa(k0, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nj) {
        uint32_t bh0, bh1, bl0, bl1;
        fb(j, k0, bh0, bh1, bl0, bl1);
        float tt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(accx[j], al, bh0, bh1);
        mma(accx[j], ah, bl0, bl1);
        mma(tt, ah, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += tt[e];
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
}

// the A fragment's elements (r0 + g, k0 + t), (r0 + g + 8, k0 + t),
// (r0 + g, k0 + t + 4), (r0 + g + 8, k0 + t + 4) of a tile stored at
// r * rs + k * ks, split as they are read
__device__ __forceinline__ void a_frag(const float* x, int r0, int k0, int rs,
                                       int ks, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int o = (r0 + lane_g()) * rs + (k0 + lane_t()) * ks;
  split(x[o], ah[0], al[0]);
  split(x[o + 8 * rs], ah[1], al[1]);
  split(x[o + 4 * ks], ah[2], al[2]);
  split(x[o + 8 * rs + 4 * ks], ah[3], al[3]);
}

// from planes split when written
__device__ __forceinline__ void a_planes(const float* hi, const float* lo,
                                         int r0, int k0, int rs, int ks,
                                         uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  const int o = (r0 + lane_g()) * rs + (k0 + lane_t()) * ks;
  const int at[4] = {o, o + 8 * rs, o + 4 * ks, o + 8 * rs + 4 * ks};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = __float_as_uint(hi[at[i]]);
    al[i] = __float_as_uint(lo[at[i]]);
  }
}

// the B fragment's elements (k0 + t, n0 + g) and (k0 + t + 4, n0 + g) of a
// tile stored at k * ks + n * ns, split as they are read
__device__ __forceinline__ void b_frag(const float* x, int k0, int n0, int ks,
                                       int ns, uint32_t& bh0, uint32_t& bh1,
                                       uint32_t& bl0, uint32_t& bl1) {
  const int o = (k0 + lane_t()) * ks + (n0 + lane_g()) * ns;
  split(x[o], bh0, bl0);
  split(x[o + 4 * ks], bh1, bl1);
}

// rows r0 .. r0+nr-1 (< rmax) and columns c0 .. c0+w-1 (< cmax) of a
// row-major source of row stride `stride` into dst (row stride ld) with
// cp.async, zeros elsewhere.  `vec`: 16-byte copies (w, ld, stride, c0 and
// cmax multiples of 4, the source 16-byte aligned).  A row's copies go to
// a power of two of threads, so no thread divides
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          int stride, int r0, int nr,
                                          int rmax, int c0, int w, int cmax,
                                          bool vec) {
  const int u = vec ? 4 : 1, per = vec ? w >> 2 : w;
  const int sh = per > 1 ? 32 - __clz(per - 1) : 0;   // 2^sh >= per
  const int c = (threadIdx.x & ((1 << sh) - 1)) * u;
  if (c >= w) return;
  for (int r = threadIdx.x >> sh; r < nr; r += kThreads >> sh) {
    const bool ok = r0 + r < rmax && c0 + c < cmax;
    cp_async(dst + r * ld + c,
             ok ? src + (size_t)(r0 + r) * stride + c0 + c : src, ok, vec);
  }
}

// entries r0 .. r0+31 (< n) of a vector into dst with cp.async (threads
// 0-31), zeros past n
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int r0,
                                         int n) {
  if (threadIdx.x < kT) {
    const bool ok = r0 + (int)threadIdx.x < n;
    cp_async(dst + threadIdx.x, ok ? src + r0 + threadIdx.x : src, ok, false);
  }
}

__device__ __forceinline__ void cp_wait_n(int n) {
  if (n >= 2) cp_wait<2>();
  else if (n == 1) cp_wait<1>();
  else cp_wait<0>();
}

// A key tile's steps, in order: for each row tile i >= j, nc C.B^T steps
// (C_i's 64-wide slices) then a step per head (dy_i); then for each 32
// state dims, a step per head (ds's rows).  A step also names its ring
// stage.  The block walks them with next(), no division on the way
struct Step {
  int kind;  // 0: C.B^T, 1: dy, 2: s_local
  int i, c, hh, stage;

  __device__ __forceinline__ void next(int nt, int nc, int hs, int ns) {
    if (++stage == ns) stage = 0;
    if (kind == 0) {
      if (++c == nc) {
        kind = 1;
        c = 0;
      }
    } else if (kind == 1) {
      if (++hh == hs) {
        hh = 0;
        if (++i == nt) {
          kind = 2;
          i = 0;
        } else {
          kind = 0;
        }
      }
    } else if (++hh == hs) {
      hh = 0;
      ++c;
    }
  }
};

// issue step s's copies into its stage
__device__ __forceinline__ void issue_step(const Args& a, const Layout& L,
                                           float* smem, const Step& s,
                                           int bc, int bcg, int h0) {
  float* st = smem + s.stage * L.SF;
  const int Q = a.Q, N = a.N, P = a.P;
  if (s.kind == 0) {
    copy_tile(st, kLC, a.cm + (size_t)bcg * Q * N, N, s.i * kT, kT, Q,
              s.c * kCB, min(kCB, a.NK - s.c * kCB), N, a.vec);
    return;
  }
  const size_t bh = (size_t)bc * a.H + h0 + s.hh;
  if (s.kind == 1) {
    copy_tile(st, L.LP, a.dy + bh * Q * P, P, s.i * kT, kT, Q, 0, L.PK, P,
              a.vec);
    copy_vec(smem + L.vec + s.stage * kT, a.cs + bh * Q, s.i * kT, Q);
    return;
  }
  copy_tile(st, L.LP, a.ds + bh * N * P, P, s.c * kSL, kSL, N, 0, L.PK, P,
            a.vec);
}

// The cluster barrier in two halves: once every thread of the cluster has
// arrived, the global writes each made before arriving are visible to all
// that have passed the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// dcs at the rows of tile t for heads h0 .. h0+nh-1 of chunk bc: its
// column terms (already in dcs) + its row partials in key-tile order (+ at
// Q-1 the s_local terms' sums, in key-tile order)
__device__ __forceinline__ void dcs_rows(const Args& a, int bc, int t, int h0,
                                         int nh) {
  const int Q = a.Q, nt = a.nt;
  for (int e = threadIdx.x; e < nh * kT; e += kThreads) {
    const int k = t * kT + e % kT;
    if (k >= Q) continue;
    const size_t bh = (size_t)bc * a.H + h0 + e / kT;
    const float* rp = a.rowpart + (bh * Q + k) * nt;
    float rv[8], ev[8], rs = 0.0f, es = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      rv[u] = u <= t ? rp[u] : 0.0f;
      ev[u] = k == Q - 1 && u < nt ? a.esum[bh * nt + u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (u <= t) rs += rv[u];
      if (u < nt) es += ev[u];
    }
    float v = a.dcs[bh * Q + k] + rs;
    if (k == Q - 1) v += es;
    a.dcs[bh * Q + k] = v;
  }
}

// One sums task of a (chunk, group) bcg over N's column tiles c0 ..
// c0+cw-1 (cw <= 32 NT): dC_t = sum_{j <= t} S_tj B_j (kind 0) or dB_t =
// sum_{i >= t} S_it^T C_i + the splits' w E partials (kind 1), S the
// splits' tiles summed in split order, each tile pair's product in a fresh
// accumulator.  The next pair's B or C rows (cp.async) and S loads are in
// flight while a pair is multiplied, and the next DB splits' w E
// partials; the first pair's loads are in flight while dcs_rows finishes
// dcs for heads dh0 .. dh0+dnh-1 at the rows of tile dtile (dnh 0: none).
// `wait`: the first pair's B or C rows are requested, then the cluster's
// wait passed, before any partial is read.  sm: kSumsFloats floats of
// shared memory; SB and DB: the splits' S tiles and w E partials in
// flight at once
template <int NT, int SB, int DB>
__device__ __forceinline__ void sums_task(const Args& a, float* sm, int kind,
                                          int t, int c0, int cw, int bcg,
                                          int dtile, int dh0, int dnh,
                                          bool wait) {
  float* sS = sm;                       // two S tiles
  float* sM = sm + 2 * kT * kLT;        // two slices of B or C rows
  const int Q = a.Q, N = a.N, nt = a.nt, splits = a.splits;
  const int np = kind == 0 ? t + 1 : nt - t;
  const int tid = threadIdx.x, warp = tid >> 5, gl = lane_g(), tl = lane_t();
  const int rh = warp & 1, cg = warp >> 1;
  const int nj = cw / 8 > cg ? (cw / 8 - cg + 3) / 4 : 0;
  const size_t BCG = (size_t)a.BC * a.G, gqn = (size_t)bcg * Q * N;
  const int npairs = nt * (nt + 1) / 2;
  const size_t sstride = BCG * npairs * kT * kT, dstride = BCG * Q * N;
  const int sr = tid / (kT / 4), sc = (tid % (kT / 4)) * 4;   // a float4

  // pair k: kind 0 (t, k) against B_k; kind 1 (t + k, t) against C_{t+k}
  auto s_src = [&](int k) {
    const int i = kind == 0 ? t : t + k, j = kind == 0 ? k : t;
    return a.spart + ((size_t)bcg * npairs + i * (i + 1) / 2 + j) * kT * kT +
           sr * kT + sc;
  };
  auto issue_m = [&](int k) {
    copy_tile(sM + (k & 1) * kT * kLM, kLM, (kind == 0 ? a.bm : a.cm) + gqn,
              N, (kind == 0 ? k : t + k) * kT, kT, Q, c0, cw, N, a.vec);
    cp_commit();
  };
  float4 ld[SB];
  auto issue_s = [&](int k) {
    const float* src = s_src(k);
#pragma unroll
    for (int u = 0; u < SB; ++u)
      if (u < splits)
        ld[u] = *reinterpret_cast<const float4*>(src + u * sstride);
  };
  auto finish_s = [&](int k) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < SB; ++u)
      if (u < splits) {
        v.x += ld[u].x;
        v.y += ld[u].y;
        v.z += ld[u].z;
        v.w += ld[u].w;
      }
    const float* src = s_src(k);
    for (int q0 = SB; q0 < splits; q0 += SB) {
      float4 p[SB];
#pragma unroll
      for (int u = 0; u < SB; ++u)
        if (q0 + u < splits)
          p[u] = *reinterpret_cast<const float4*>(src + (q0 + u) * sstride);
#pragma unroll
      for (int u = 0; u < SB; ++u)
        if (q0 + u < splits) {
          v.x += p[u].x;
          v.y += p[u].y;
          v.z += p[u].z;
          v.w += p[u].w;
        }
    }
    *reinterpret_cast<float4*>(sS + (k & 1) * kT * kLT + sr * kLT + sc) = v;
  };
  // kind 1: batch b of the splits' w E partials (DB splits) at this
  // thread's output elements, loaded, then summed in split order
  const int nb = kind == 1 ? (splits + DB - 1) / DB : 0;
  float dp[DB][NT][4], dbs[NT][4];
  zero(dbs);
  auto load_db = [&](int b) {
#pragma unroll
    for (int u = 0; u < DB; ++u)
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = b * DB + u;
          const int r = t * kT + rh * 16 + gl + (e >> 1) * 8;
          const int c = c0 + (cg + 4 * jj) * 8 + 2 * tl + (e & 1);
          dp[u][jj][e] = q < splits && jj < nj && r < Q && c < N
              ? a.dbpart[q * dstride + gqn + (size_t)r * N + c] : 0.0f;
        }
  };
  auto add_db = [&](int b) {
#pragma unroll
    for (int u = 0; u < DB; ++u)
      if (b * DB + u < splits)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) dbs[jj][e] += dp[u][jj][e];
  };

  issue_m(0);
  if (wait) cluster_wait();
  issue_s(0);
  if (nb > 0) load_db(0);
  if (dnh > 0) dcs_rows(a, bcg / a.G, dtile, dh0, dnh);
  if (nb > 0) add_db(0);
  finish_s(0);
  float tsum[NT][4];
  zero(tsum);
  for (int k = 0; k < np; ++k) {
    cp_wait<0>();
    __syncthreads();                 // pair k is in place; k-1 is done
    if (k + 1 < np) {
      issue_m(k + 1);
      issue_s(k + 1);
    }
    const bool more = k + 1 < nb;    // the next batch of w E partials
    if (more) load_db(k + 1);
    float pa[NT][4], px[NT][4];
    zero(pa);
    zero(px);
    const float* ss = sS + (k & 1) * kT * kLT;
    const float* sm2 = sM + (k & 1) * kT * kLM;
    warp_mm<NT>(
        kT, nj,
        [&](int k0, uint32_t(&ah)[4], uint32_t(&al)[4]) {
          if (kind == 0) a_frag(ss, rh * 16, k0, kLT, 1, ah, al);   // S_tj
          else a_frag(ss, rh * 16, k0, 1, kLT, ah, al);            // S_it^T
        },
        [&](int jj, int k0, uint32_t& bh0, uint32_t& bh1, uint32_t& bl0,
            uint32_t& bl1) {
          b_frag(sm2, k0, (cg + 4 * jj) * 8, kLM, 1, bh0, bh1, bl0, bl1);
        },
        pa, px);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) tsum[jj][e] += pa[jj][e] + px[jj][e];
    if (more) add_db(k + 1);
    if (k + 1 < np) finish_s(k + 1);
  }
  for (int b = np + 1; b < nb; ++b) {
    load_db(b);
    add_db(b);
  }
  float* out = (kind == 0 ? a.dc : a.db) + gqn;
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    if (jj < nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = t * kT + rh * 16 + gl + (e >> 1) * 8;
        const int c = c0 + (cg + 4 * jj) * 8 + 2 * tl + (e & 1);
        if (r < Q && c < N)
          out[(size_t)r * N + c] = kind == 0 ? tsum[jj][e]
                                             : tsum[jj][e] + dbs[jj][e];
      }
    }
  }
}

// NTP: 16x8 tiles of P a warp sums at once (32 NTP >= P); FUSED: the
// launch's clusters hold each chunk and group's blocks, which then do the
// sums too
template <int NTP, bool FUSED>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_main(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hg = a.H / a.G, hsmax = (hg + a.splits - 1) / a.splits;
  const Layout L(a.P, a.N, hsmax, stages(a.P, a.N, hsmax));
  const int PK = L.PK, LP = L.LP, ns = L.ns;
  const int sp = blockIdx.x % a.splits, bcg = blockIdx.x / a.splits;
  const int bc = bcg / a.G, g = bcg % a.G;
  const int h0 = g * hg + sp * hg / a.splits;
  const int hs = g * hg + (sp + 1) * hg / a.splits - h0;
  const int Q = a.Q, N = a.N, P = a.P, NK = a.NK, nt = a.nt;
  const int nc = (NK + kCB - 1) / kCB, nsl = (NK + kSL - 1) / kSL;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gl = lane_g(), tl = lane_t();
  const int rh = warp & 1, cg = warp >> 1;   // row half, column group
  const size_t BCG = (size_t)a.BC * a.G;
  const int npairs = nt * (nt + 1) / 2;
  float* sWh = smem + L.w;
  float* sWl = sWh + kT * kLT;
  float* srow = smem + L.rowp;

  const int jt = blockIdx.y, j0 = jt * kT;
  const int steps = (nt - jt) * (nc + hs) + nsl * hs;
  // with the first step: B_j, each head's x_j, cs_j, dt_j and cs_{Q-1}
  // (into e_j's slot, each entry); dx_j's sums and the column sums zeroed
  copy_tile(smem + L.hb, L.LB, a.bm + (size_t)bcg * Q * N, N, j0, kT, Q, 0,
            L.LB - 4, N, a.vec);
  for (int hh = 0; hh < hs; ++hh) {
    const size_t bh = (size_t)bc * a.H + h0 + hh;
    float* hv = smem + L.hv + hh * kHV * kT;
    copy_tile(smem + L.hx + hh * kT * LP, LP, a.x + bh * Q * P, P, j0, kT,
              Q, 0, PK, P, a.vec);
    copy_vec(hv, a.cs + bh * Q, j0, Q);
    copy_vec(hv + kT, a.dt + bh * Q, j0, Q);
    if (tid < kT) cp_async(hv + 2 * kT + tid, a.cs + bh * Q + Q - 1, true,
                           false);
    float* dxh = smem + L.hdx + hh * kT * LP;
    for (int e = tid; e < kT * LP; e += kThreads) dxh[e] = 0.0f;
    for (int e = tid; e < 6 * kT; e += kThreads) hv[4 * kT + e] = 0.0f;
  }
  Step issue{0, jt, 0, 0, 0}, s = issue;    // the next to issue, to run
  for (int k = 0; k < ns - 1; ++k) {
    if (k < steps) {
      issue_step(a, L, smem, issue, bc, bcg, h0);
      issue.next(nt, nc, hs, ns);
    }
    cp_commit();
  }

  float cba[1][4], cbx[1][4], cb[4], sacc[4], dbl[4];
  for (int k = 0; k < steps; ++k, s.next(nt, nc, hs, ns)) {
    cp_wait_n(ns - 2);             // this thread's copies of step k
    __syncthreads();               // step k landed; step k-1 is done
    if (k + ns - 1 < steps) {
      issue_step(a, L, smem, issue, bc, bcg, h0);
      issue.next(nt, nc, hs, ns);
    }
    cp_commit();
    if (k == 0 && tid < hs * kT) {
      // e_j = exp(cs_{Q-1} - cs_j), w_j = e_j dt_j (0 past Q)
      float* hv = smem + L.hv + (tid / kT) * kHV * kT;
      const int r = tid % kT;
      const float ej = j0 + r < Q ? expf(hv[2 * kT + r] - hv[r]) : 0.0f;
      hv[2 * kT + r] = ej;
      hv[3 * kT + r] = ej * hv[kT + r];
    }
    const float* st = smem + s.stage * L.SF;
    const int hh = s.hh;
    const float* xh = smem + L.hx + hh * kT * LP;
    float* dxh = smem + L.hdx + hh * kT * LP;
    float* hv = smem + L.hv + hh * kHV * kT;
    const float* sb = smem + L.hb;

    if (s.kind == 0) {
      // C.B^T over this step's 64 state dims, summed over the steps
      if (s.c == 0) {
        zero(cba);
        zero(cbx);
      }
      const float* bc0 = sb + s.c * kCB;
      warp_mm<1>(
          min(kCB, NK - s.c * kCB), 1,
          [&](int k0, uint32_t(&ah)[4], uint32_t(&al)[4]) {
            a_frag(st, rh * 16, k0, kLC, 1, ah, al);
          },
          [&](int, int k0, uint32_t& bh0, uint32_t& bh1, uint32_t& bl0,
              uint32_t& bl1) {
            b_frag(bc0, k0, cg * 8, 1, L.LB, bh0, bh1, bl0, bl1);
          },
          cba, cbx);
      continue;
    }

    if (s.kind == 1) {
      const int i0 = s.i * kT;
      if (hh == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cb[e] = cba[0][e] + cbx[0][e];
          sacc[e] = 0.0f;
        }
      }
      // dM = dy_i . x_j^T: this warp's 16 rows and 8 keys
      float dma[1][4], dmx[1][4];
      zero(dma);
      zero(dmx);
      warp_mm<1>(
          PK, 1,
          [&](int k0, uint32_t(&ah)[4], uint32_t(&al)[4]) {
            a_frag(st, rh * 16, k0, LP, 1, ah, al);
          },
          [&](int, int k0, uint32_t& bh0, uint32_t& bh1, uint32_t& bl0,
              uint32_t& bl1) {
            b_frag(xh, k0, cg * 8, 1, LP, bh0, bh1, bl0, bl1);
          },
          dma, dmx);
      // W, dM L dt and T of the fragment; L only where j <= i < Q
      const float* csi = smem + L.vec + s.stage * kT;
      float tt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rh * 16 + gl + (e >> 1) * 8;
        const int c = cg * 8 + 2 * tl + (e & 1);
        const int i = i0 + r, j = j0 + c;
        float w = 0.0f, dcb = 0.0f, tv = 0.0f;
        if (i < Q && j <= i) {
          const float l = expf(csi[r] - hv[c]);
          const float dm = dma[0][e] + dmx[0][e], dtc = hv[kT + c];
          w = cb[e] * l * dtc;
          dcb = dm * l * dtc;
          tv = dm * cb[e] * l;
        }
        sacc[e] += dcb;
        tt[e] = tv;
        float wh, wl;
        splitf(w, wh, wl);
        sWh[r * kLT + c] = wh;
        sWl[r * kLT + c] = wl;
      }
      // T's column sums over this warp's 16 rows (lanes of one t hold
      // the same sum), added to the row half's sums over i
      float c0s = tt[0] + tt[2], c1s = tt[1] + tt[3];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        c0s += __shfl_xor_sync(kFull, c0s, m);
        c1s += __shfl_xor_sync(kFull, c1s, m);
      }
      if (gl == 0) {
        hv[(4 + rh) * kT + cg * 8 + 2 * tl] += c0s;
        hv[(4 + rh) * kT + cg * 8 + 2 * tl + 1] += c1s;
      }
      // T dt's row sums over this warp's 8 keys
      const float d0 = hv[kT + cg * 8 + 2 * tl];
      const float d1 = hv[kT + cg * 8 + 2 * tl + 1];
      float r0s = tt[0] * d0 + tt[1] * d1, r1s = tt[2] * d0 + tt[3] * d1;
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        r0s += __shfl_xor_sync(kFull, r0s, m);
        r1s += __shfl_xor_sync(kFull, r1s, m);
      }
      if (tl == 0) {
        srow[cg * kT + rh * 16 + gl] = r0s;
        srow[cg * kT + rh * 16 + gl + 8] = r1s;
      }
      __syncthreads();             // W and the row sums are in place
      // dx_j += W^T dy_i: this warp's 16 keys, column tiles cg + 4m
      const int ntp = PK / 8;
      const int nj = ntp > cg ? (ntp - cg + 3) / 4 : 0;
      float da[NTP][4], dxx[NTP][4];
      zero(da);
      zero(dxx);
      warp_mm<NTP>(
          kT, nj,
          [&](int k0, uint32_t(&ah)[4], uint32_t(&al)[4]) {
            a_planes(sWh, sWl, rh * 16, k0, 1, kLT, ah, al);
          },
          [&](int jj, int k0, uint32_t& bh0, uint32_t& bh1, uint32_t& bl0,
              uint32_t& bl1) {
            b_frag(st, k0, (cg + 4 * jj) * 8, LP, 1, bh0, bh1, bl0, bl1);
          },
          da, dxx);
#pragma unroll
      for (int jj = 0; jj < NTP; ++jj) {
        if (jj < nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rh * 16 + gl + (e >> 1) * 8;
            const int c = (cg + 4 * jj) * 8 + 2 * tl + (e & 1);
            dxh[r * LP + c] += da[jj][e] + dxx[jj][e];
          }
        }
      }
      if (tid < kT && i0 + tid < Q) {
        const float v = srow[tid] + srow[kT + tid] + srow[2 * kT + tid] +
                        srow[3 * kT + tid];
        a.rowpart[(((size_t)bc * a.H + h0 + hh) * Q + i0 + tid) * nt + jt] =
            v;
      }
      if (hh == hs - 1) {
        // the pair's S, summed over the split's heads
        float* out = a.spart + (((size_t)sp * BCG + bcg) * npairs +
                                s.i * (s.i + 1) / 2 + jt) * kT * kT;
        const int r = rh * 16 + gl, c = cg * 8 + 2 * tl;
        *reinterpret_cast<float2*>(out + r * kT + c) =
            make_float2(sacc[0], sacc[1]);
        *reinterpret_cast<float2*>(out + (r + 8) * kT + c) =
            make_float2(sacc[2], sacc[3]);
      }
      continue;
    }

    // s_local, 32 state dims n0.. of one head: ds's rows in the stage
    const float* dsr = st;
    const int n0 = s.c * kSL, kv = min(kSL, NK - n0);
    // E = x_j . ds^T: this warp's 16 keys x 8 state dims
    if (hh == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dbl[e] = 0.0f;
    }
    float ea[1][4], ex[1][4];
    zero(ea);
    zero(ex);
    warp_mm<1>(
        PK, 1,
        [&](int k0, uint32_t(&ah)[4], uint32_t(&al)[4]) {
          a_frag(xh, rh * 16, k0, LP, 1, ah, al);
        },
        [&](int, int k0, uint32_t& bh0, uint32_t& bh1, uint32_t& bl0,
            uint32_t& bl1) {
          b_frag(dsr, k0, cg * 8, 1, LP, bh0, bh1, bl0, bl1);
        },
        ea, ex);
    // the split's w E (registers, over its heads); u_j += B_j . E_j over
    // this warp's 8 state dims (lanes of one g hold the same sum)
    float up[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rh * 16 + gl + (e >> 1) * 8;
      const int c = n0 + cg * 8 + 2 * tl + (e & 1);
      const float ev = ea[0][e] + ex[0][e];
      dbl[e] += hv[3 * kT + r] * ev;
      up[e] = sb[r * L.LB + c] * ev;
    }
    float u0s = up[0] + up[1], u1s = up[2] + up[3];
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      u0s += __shfl_xor_sync(kFull, u0s, m);
      u1s += __shfl_xor_sync(kFull, u1s, m);
    }
    if (tl == 0) {
      hv[(6 + cg) * kT + rh * 16 + gl] += u0s;
      hv[(6 + cg) * kT + rh * 16 + gl + 8] += u1s;
    }
    if (hh == hs - 1) {
      float* out = a.dbpart + ((size_t)sp * BCG + bcg) * Q * N;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j0 + rh * 16 + gl + (e >> 1) * 8;
        const int c = n0 + cg * 8 + 2 * tl + (e & 1);
        if (r < Q && c < N) out[(size_t)r * N + c] = dbl[e];
      }
    }
    // dx_j += w_j (B_j ds): this warp's 16 keys, column tiles cg + 4m
    const int ntp = PK / 8;
    const int nj = ntp > cg ? (ntp - cg + 3) / 4 : 0;
    float va[NTP][4], vx[NTP][4];
    zero(va);
    zero(vx);
    warp_mm<NTP>(
        kv, nj,
        [&](int k0, uint32_t(&ah)[4], uint32_t(&al)[4]) {
          a_frag(sb + n0, rh * 16, k0, L.LB, 1, ah, al);
        },
        [&](int jj, int k0, uint32_t& bh0, uint32_t& bh1, uint32_t& bl0,
            uint32_t& bl1) {
          b_frag(dsr, k0, (cg + 4 * jj) * 8, LP, 1, bh0, bh1, bl0, bl1);
        },
        va, vx);
#pragma unroll
    for (int jj = 0; jj < NTP; ++jj) {
      if (jj < nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rh * 16 + gl + (e >> 1) * 8;
          const int c = (cg + 4 * jj) * 8 + 2 * tl + (e & 1);
          dxh[r * LP + c] += hv[3 * kT + r] * (va[jj][e] + vx[jj][e]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                 // every step is done
  // ddt and dcs's column terms; w u's sum for dcs at Q-1
  for (int e = tid; e < hs * kT; e += kThreads) {
    const int hh = e / kT, r = e % kT;
    const size_t bh = (size_t)bc * a.H + h0 + hh;
    float* hv = smem + L.hv + hh * kHV * kT;
    const float col = hv[4 * kT + r] + hv[5 * kT + r];
    const float u = hv[6 * kT + r] + hv[7 * kT + r] + hv[8 * kT + r] +
                    hv[9 * kT + r];
    const float wu = hv[3 * kT + r] * u;
    if (j0 + r < Q) {
      a.ddt[bh * Q + j0 + r] = col + hv[2 * kT + r] * u;
      a.dcs[bh * Q + j0 + r] = -(hv[kT + r] * col) - wu;
    }
    hv[6 * kT + r] = wu;
  }
  __syncthreads();
  if (tid < hs) {
    const float* wu = smem + L.hv + tid * kHV * kT + 6 * kT;
    float s = 0.0f;
    for (int r = 0; r < kT; ++r) s += wu[r];
    a.esum[((size_t)bc * a.H + h0 + tid) * nt + jt] = s;
  }
  // the cluster holds this chunk and group's blocks: this one's partials
  // are written (the arrival releases them; dx_j's stores, which no other
  // block reads, come after it)
  if (FUSED) cluster_arrive();
  // dx_j
  for (int hh = 0; hh < hs; ++hh) {
    const size_t bh = (size_t)bc * a.H + h0 + hh;
    const float* dxh = smem + L.hdx + hh * kT * LP;
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, c = e % P;
      if (j0 + r < Q) a.dx[(bh * Q + j0 + r) * P + c] = dxh[r * LP + c];
    }
  }
  if (!FUSED) return;
  __syncthreads();                 // dx_j read: the sums take the memory
  // once every block has arrived, they share out the sums tasks (dC's
  // ranges by tile, then dB's), and each finishes dcs for its own heads
  // and tile
  const int nblk = a.splits * nt, r = sp + a.splits * jt;
  const int tiles = NK / 8, per = (tiles + a.parts - 1) / a.parts;
  const int ntask = 2 * nt * a.parts;
  for (int task = r; task < ntask; task += nblk) {
    if (task != r) __syncthreads();          // the last task's smem is free
    const int kind = task / (nt * a.parts), rest = task % (nt * a.parts);
    const int c0 = rest % a.parts * per * 8;
    sums_task<1, kBatch / 2, kDbBatch / 2>(
        a, smem, kind, rest / a.parts, c0, min(per * 8, NK - c0), bcg, jt,
        h0, task == r ? hs : 0, task == r);
  }
  if (r >= ntask) {
    cluster_wait();
    dcs_rows(a, bc, jt, h0, hs);
  }
}

// The second launch, where a cluster does not hold a chunk and group's
// first-launch blocks: a block a (tile t, kind and range of N, chunk and
// group), blockIdx.y < parts dC's ranges and the rest dB's; dC's range-0
// block also finishes dcs for the group's heads at the rows of t
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sums(const Args a) {
  __shared__ __align__(16) float sm[kSumsFloats];
  const int t = blockIdx.x, bcg = blockIdx.z;
  const int kind = blockIdx.y / a.parts, part = blockIdx.y % a.parts;
  const int tiles = a.NK / 8, per = (tiles + a.parts - 1) / a.parts;
  const int c0 = part * per * 8, hg = a.H / a.G;
  sums_task<kMaxT, kBatch, kDbBatch>(
      a, sm, kind, t, c0, min(per * 8, a.NK - c0), bcg, t, (bcg % a.G) * hg,
      kind == 0 && part == 0 ? hg : 0, false);
}

}  // namespace

// The first launch's shared memory at P with `hs` heads a split (bytes):
// kernel.py::bwd_smem mirrors it, and the card holds the mirror to this
extern "C" int ssd_scan_bwd_smem(int P, int N, int hs) {
  return (int)Layout(P, N, hs, stages(P, N, hs)).bytes();
}

// x, dy (BC, H, Q, P), B/C (BC, G, Q, N), cs/dt (BC, H, 1, Q), ds (BC, H,
// N, P) float32 contiguous -> dx (BC, H, Q, P), dB/dC (BC, G, Q, N),
// dcs/ddt (BC, H, 1, Q); scratch (kernel.py::bwd_plan's sizes): spart
// (splits, BC G, nt (nt+1) / 2, 32, 32), dbpart (splits, BC G, Q, N),
// rowpart (BC, H, Q, nt), esum (BC, H, nt), nt = ceil(Q / 32).  `splits`
// of each group's heads and `parts` ranges of N's column tiles in the
// sums: the plan's.  Where a chunk and group's splits x nt blocks fit a
// cluster (at most kMaxCluster), one launch of clusters on `stream` does
// the sums too (ranges of at most 4 column tiles); else two launches.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* bm, const void* cm,
                                const void* cs, const void* dt, const void* dy,
                                const void* ds, void* dx, void* db, void* dc,
                                void* dcs, void* ddt, void* spart,
                                void* dbpart, void* rowpart, void* esum,
                                int BC, int H, int G, int Q, int P, int N,
                                int splits, int parts, void* stream) {
  if (BC <= 0 || H <= 0 || G <= 0 || H % G || Q <= 0 || Q > 256 || P <= 0 ||
      P > 128 || N <= 0 || N > 256)
    return (int)cudaErrorInvalidValue;
  const int hg = H / G, NK = round8(N), tiles = NK / 8;
  const int nt = (Q + kT - 1) / kT;
  const bool fused = splits >= 1 && splits * nt <= kMaxCluster;
  if (splits < 1 || splits > hg || parts < 1 ||
      parts > tiles || (tiles + parts - 1) / parts > (fused ? 4 : 16) ||
      (long long)BC * G > 65535 ||
      (long long)BC * G * splits > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hs = (hg + splits - 1) / splits;
  const size_t smem = Layout(P, N, hs, stages(P, N, hs)).bytes();
  if (smem > (size_t)kSmemBlock || smem < sizeof(float) * kSumsFloats)
    return (int)cudaErrorInvalidValue;
  void (*main_fn)(Args) =
      P <= 32 ? (fused ? ssd_bwd_main<1, true> : ssd_bwd_main<1, false>)
      : P <= 64 ? (fused ? ssd_bwd_main<2, true> : ssd_bwd_main<2, false>)
                : (fused ? ssd_bwd_main<4, true> : ssd_bwd_main<4, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)main_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a;
  a.x = (const float*)x;
  a.bm = (const float*)bm;
  a.cm = (const float*)cm;
  a.cs = (const float*)cs;
  a.dt = (const float*)dt;
  a.dy = (const float*)dy;
  a.ds = (const float*)ds;
  a.dx = (float*)dx;
  a.db = (float*)db;
  a.dc = (float*)dc;
  a.dcs = (float*)dcs;
  a.ddt = (float*)ddt;
  a.spart = (float*)spart;
  a.dbpart = (float*)dbpart;
  a.rowpart = (float*)rowpart;
  a.esum = (float*)esum;
  a.BC = BC;
  a.H = H;
  a.G = G;
  a.Q = Q;
  a.P = P;
  a.N = N;
  a.NK = NK;
  a.nt = nt;
  a.splits = splits;
  a.parts = parts;
  // 16-byte copies where every row allows
  a.vec = N % 4 == 0 && P % 4 == 0 &&
      ((((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm | (uintptr_t)dy |
         (uintptr_t)ds) & 15u) == 0);
  // key tile 0 (the most rows) in the first blocks launched, tile nt-1 in
  // the last: the card deals the heaviest blocks out first
  if (fused) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(BC * G * splits, nt);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = nt;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, main_fn, a);
  }
  main_fn<<<dim3(BC * G * splits, nt), kThreads, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_sums<<<dim3(nt, 2 * parts, BC * G), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
