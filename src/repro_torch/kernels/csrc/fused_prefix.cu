// fused_prefix.cu: a plan's whole pixel prefix in one pass per frame: the
// frame-diff activity grid, one near-colour fraction per cheap filter, the
// cropped / downscaled / normalized frame, and the signature patch means.
//
// Replaces: src/repro/kernels/fused_prefix/kernel.py, fused_prefix_kernel
// (Pallas body _prefix_kernel, one program per frame walking a static
// stage tuple, the frame held in VMEM).
//
// Bound on an H100: bytes.  The function reads each frame and its
// predecessor once and writes the transformed frame and a few statistics;
// it does a handful of operations per byte.  At the main path's shape
// (B=16 uint8 3x128x256 frames and predecessors, diff 4x8, preprocess crop
// 64x256 /2, one colour, signature 8x16 on the 3x32x128 result) that is
// 3.15 MB read and 0.81 MB written, about 1.2 us at 3.35 TB/s.
//
// Design: one thread-block cluster of K blocks (K = 8, the portable
// maximum) a frame, on neighbouring SMs that read each other's shared
// memory (distributed shared memory): the card's counterpart of the TPU
// kernel holding a frame in VMEM.  At B 16 that is 128 blocks.
//   - Every buffer of a frame is cut into K bands of rows: rows
//     [q*band, (q+1)*band) of every channel live in block q's shared memory.
//     Each block copies its band of the frame, and of the previous frame
//     when the spec has a diff, with 16-byte cp.async; preprocessed frames
//     (x and the two ping-pong scratch frames) live in bands too, never in
//     device memory.  A stage reads any element from the block whose band
//     holds it (cluster.map_shared_rank), but each block takes the items
//     whose first source row lies in its own band (diff: its band's rows;
//     colour and copy: window rows; signature: patch rows), so reads are
//     local but where a window straddles two bands.  A preprocess splits
//     its output rows evenly instead (taking the rows whose source is
//     local left half the cluster idle at the path spec and measured
//     slower): each block writes its own band of the destination, after
//     it has copied the source rows of its outputs from the bands that
//     hold them into its own shared memory, all threads at once, so the
//     remote reads cost one latency, not one a window row.
//   - The descriptor is a __grid_constant__ parameter (a by-value one
//     indexed at run time is copied to local memory); a stage copies its
//     entry to registers and walks rows: one division and one address
//     map a row, not an element.
//   - The plan (kernel.py: cluster_plan) is made on the host: each
//     buffer's band rows and offset in shared memory, the reduction slots,
//     and a cluster.sync() before each stage that reads a band written
//     since the last one (or writes a band read since).  At the path spec:
//     one after the load, one after the preprocess, one at the end.
//   - Per-frame reductions: each block adds its items in a fixed order and
//     writes one partial per (slot, block); after a cluster.sync() the
//     partials are combined in block order.  Diff sums and colour counts
//     are integers (exact); the window max that decides raw vs normalized
//     for colour and signature (max > 8, per frame) is order free.  Colour
//     counts both readings of every pixel in its one pass and keeps the one
//     the max picks.  The signature knows the max before it sums (keeping
//     both sums, the raw reading's division on every element cost more):
//     from a colour stage on the same window (the path spec's case) or
//     from a pass of its own, then a cluster.sync().
//   - x is written to device memory once, coalesced, by the block that
//     owns each band, after the last stage.
// The arithmetic of each value is unchanged from the kernel it replaces:
// the diff is diff.cuh's (so d equals frame_diff.cu's), a preprocess value
// sums its f x f window as an integer (uint8 source) or dy-then-dx in
// float, through preprocess.cuh (so x equals fused_preprocess.cu's), a
// colour distance is rounded in the plain version's order, and a
// signature patch is summed by one thread, dy then dx.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/pixel_compare.py,
// recorded in PERF.md): 0.0190 ms at the path spec (0.0255 on float32
// frames), against 0.0428 (0.1041) for the earlier design (one block of
// 512 threads a frame, the frames round-tripping through device memory)
// and 0.0019 for an empty kernel on the same cluster grid.  Every phase
// is a chain of dependent steps with most warps idle, not bytes
// (scripts/prefix_probe.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "diff.cuh"
#include "preprocess.cuh"

namespace cg = cooperative_groups;

// The descriptor is outside the anonymous namespace: the C entry point
// takes it, and a type with internal linkage would hide that symbol.
namespace prefix {

constexpr int kMaxStages = 16;  // kernel.py MAX_STAGES
constexpr int kBuffers = 5;     // kernel.py INPUT, XOUT, SCRATCH0/1, PREV

// One stage, resolved by the wrapper (kernel.py: compile_spec and
// cluster_plan).  A stage reads the window (y0, x0, h, w) of buffer `src`,
// whose frames are (C, src_h, src_w) in bands of src_band rows; a
// preprocess stage writes (C, dst_h, dst_w) to `dst` in bands of dst_band
// rows.  a, b: diff regions (ry, rx) or signature grid (gy, gx); idx:
// colour slot, or for a signature the colour stage whose window max it
// takes (-1: none); sync: a cluster.sync() before the stage.
struct Stage {
  int kind, src, src_h, src_w, src_band, y0, x0, h, w, dst, dst_h, dst_w,
      dst_band, factor, grey, a, b, idx, sync;
  float rgb[3];
};

// The cluster plan: blocks a frame, the dynamic shared memory of a block,
// each buffer's byte offset in it (-1: not held), the slots' offsets, the
// preprocess's gather area, and x's band layout when a preprocess writes
// it.
struct Spec {
  int n, blocks, smem;
  int off[kBuffers];
  int diff_slots, color_slots, sig_slots, gather;
  int x_h, x_w, x_band;
  Stage st[kMaxStages];
};

}  // namespace prefix

namespace {

using prefix::Spec;
using prefix::Stage;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // diff pairs a lane keeps in flight

enum Kind { kDiff = 0, kColor = 1, kPreprocess = 2, kSignature = 3, kCopy = 4 };
enum Buffer { kInput = 0, kOut = 1, kScratch0 = 2, kScratch1 = 3, kPrev = 4 };

#ifdef FUSED_PREFIX_PROBE
// A probe build (scripts/prefix_probe.py): at mark m the block meets a
// barrier and thread 0 writes clock64() (%globaltimer where `wall`) to
// probe_marks[block * kMarks + m].  Other builds compile no mark.
constexpr int kMarks = 40;
__device__ long long* probe_marks;
__device__ __forceinline__ void mark(int m, bool wall = false) {
  __syncthreads();
  if (threadIdx.x != 0 || probe_marks == nullptr) return;
  long long t = clock64();
  if (wall) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (m == 37) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    t = sm;
  }
  probe_marks[(size_t)blockIdx.x * kMarks + m] = t;
}
#else
__device__ __forceinline__ void mark(int, bool = false) {}
#endif

// First item i >= 0 with y0 + i * step >= y, for y0 >= 0 (kernel.py
// first_item).
__device__ __forceinline__ int first_item(int y, int y0, int step) {
  const int t = y - y0;
  return t <= 0 ? 0 : (t + step - 1) / step;
}

// The items [lo, hi) of n (window rows, step 1; signature patch rows of
// `step` source rows each) whose first source row y0 + i * step lies in
// block `rank`'s band of `band` rows: the items that block takes
// (kernel.py owned_items).
__device__ __forceinline__ int2 owned(int rank, int band, int y0, int step,
                                      int n) {
  const int lo = min(n, first_item(rank * band, y0, step));
  const int hi = min(n, first_item((rank + 1) * band, y0, step));
  return make_int2(lo, max(lo, hi));
}

// A buffer of a frame as a stage sees it: (C, h, w) elements of type E in
// bands of `band` rows, one a block; this block's band at `base`.  Channel
// c of a row is cs = band * w elements after channel 0, in every block.
template <typename E>
struct Bands {
  E* base;
  int band, w, cs, rank;

  // channel 0 of row y, in the shared memory of the block that holds it
  __device__ __forceinline__ E* row(int y) const {
    const int q = y / band;
    E* p = base + (size_t)(y - q * band) * w;
    return q == rank ? p : cg::this_cluster().map_shared_rank(p, q);
  }
};

struct Cta {
  char* smem;
  int rank, K, C;

  template <typename E>
  __device__ __forceinline__ Bands<E> bands(int off, int band, int w) const {
    return Bands<E>{reinterpret_cast<E*>(smem + off), band, w, band * w,
                    rank};
  }
  // a slot array in block q's shared memory
  template <typename E>
  __device__ __forceinline__ E* slots(int off, int q) const {
    E* p = reinterpret_cast<E*>(smem + off);
    return q == rank ? p : cg::this_cluster().map_shared_rank(p, q);
  }
};

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Block-wide reduction in a fixed order; every thread gets the result.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, V* sh, Op op) {
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < kWarps; ++i) v = op(v, sh[i]);
  __syncthreads();  // sh is reused by the next reduction
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// This block's band of a (C, H, W) frame into shared memory at `dst`.
template <typename T>
__device__ __forceinline__ void load_band(const Cta& k, T* dst,
                                          const T* frame, int H, int W,
                                          int band, int vec) {
  const int r0 = k.rank * band, rows = min(H, r0 + band) - r0;
  if (rows <= 0) return;
  const int chunk = rows * W;  // elements of a channel's band
  if (vec) {
    const int words = chunk * (int)sizeof(T) / 16, n = k.C * words;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = i / words, j = i - c * words;
      cp_async16(reinterpret_cast<char*>(dst + (size_t)c * band * W) + 16 * j,
                 reinterpret_cast<const char*>(frame +
                                               ((size_t)c * H + r0) * W) +
                     16 * j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    const int n = k.C * chunk;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = i / chunk, j = i - c * chunk;
      dst[(size_t)c * band * W + j] = frame[((size_t)c * H + r0) * W + j];
    }
  }
}

// diff: each block sums its band's rows of every region it meets, a warp a
// region, into slot (region, block) of block 0 (0 for regions it misses).
template <typename T>
__device__ __forceinline__ void diff_stage(const Cta& k, const Stage& s,
                                           int cur_off, int prev_off,
                                           int slot_off) {
  using Acc = typename std::conditional<std::is_same<T, uint8_t>::value,
                                        unsigned, float>::type;
  const int H = s.src_h, W = s.src_w, RY = s.a, RX = s.b, band = s.src_band;
  const int rh = H / RY, rw = W / RX, nreg = RY * RX;
  const int r0 = k.rank * band, r1 = min(H, r0 + band);
  const int ry0 = r0 < r1 ? r0 / rh : 0, ry1 = r0 < r1 ? (r1 - 1) / rh + 1 : 0;
  Acc* slot = k.slots<Acc>(slot_off, 0);
  for (int r = threadIdx.x; r < nreg; r += kThreads)
    if (r / RX < ry0 || r / RX >= ry1) slot[r * k.K + k.rank] = 0;
  const uint8_t* cur = reinterpret_cast<const uint8_t*>(k.smem + cur_off);
  const uint8_t* prev = reinterpret_cast<const uint8_t*>(k.smem + prev_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < (ry1 - ry0) * RX; j += kWarps) {
    const int ry = ry0 + j / RX, rx = j % RX;
    const int ya = max(r0, ry * rh), rows = min(r1, (ry + 1) * rh) - ya;
    // the region's rows in this band: (c, row, x) of cur and prev
    const size_t base = ((size_t)(ya - r0) * W + (size_t)rx * rw) * sizeof(T);
    const size_t cs = (size_t)band * W * sizeof(T), rs = (size_t)W * sizeof(T);
    Acc acc;
    if constexpr (std::is_same<T, uint8_t>::value) {
      if (W % 16 == 0 && rw % 16 == 0)
        acc = diffk::lane_sum<false, uint4, unsigned, kBatch>(
            {cur + base, prev + base, k.C, rows, rw / 16, cs, rs}, lane, 32);
      else
        acc = diffk::lane_sum<false, uint8_t, unsigned, kBatch>(
            {cur + base, prev + base, k.C, rows, rw, cs, rs}, lane, 32);
    } else {
      acc = diffk::lane_sum<false, float, float, kBatch>(
          {cur + base, prev + base, k.C, rows, rw, cs, rs}, lane, 32);
    }
    acc = diffk::warp_sum(acc);
    if (lane == 0) slot[(ry * RX + rx) * k.K + k.rank] = acc;
  }
}

// colour: fraction of the window's pixels within RGB distance 70 of the
// target; a window whose max is <= 8 holds normalized values and is mapped
// back to 0..255 first.  Products and sums are rounded one by one, in the
// plain version's order, so the per-pixel decision is the same.  Each
// block counts its window rows both ways and writes (max, count if
// normalized, count if raw) to slot (colour, block) of block 0.
template <typename E>
__device__ __forceinline__ void color_stage(const Cta& k, const Stage& s,
                                            const Bands<E>& in, unsigned* slot,
                                            int max_off, float* shf,
                                            unsigned* shu) {
  const int2 r = owned(k.rank, s.src_band, s.y0, 1, s.h);
  const int n = (r.y - r.x) * s.w;
  const float rgb[3] = {s.rgb[0], s.rgb[1], s.rgb[2]};
  float m = -INFINITY;
  unsigned cn = 0, cr = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = i % s.w, y = r.x + i / s.w;
    const E* p = in.row(s.y0 + y) + s.x0 + x;
    float dn = 0.0f, dr = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // compile_spec: colour needs 3 channels
      const float v = (float)p[c * in.cs];
      m = fmaxf(m, v);
      const float vn =
          __fmul_rn(__fadd_rn(__fmul_rn(v, 0.25f), 0.5f), 255.0f);
      const float er = __fsub_rn(v, rgb[c]), en = __fsub_rn(vn, rgb[c]);
      dr = c == 0 ? __fmul_rn(er, er) : __fadd_rn(dr, __fmul_rn(er, er));
      dn = c == 0 ? __fmul_rn(en, en) : __fadd_rn(dn, __fmul_rn(en, en));
    }
    cr += sqrtf(dr) < 70.0f ? 1u : 0u;
    cn += sqrtf(dn) < 70.0f ? 1u : 0u;
  }
  // the three partials over the block, warps in order, in one barrier
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  cn = __reduce_add_sync(0xffffffffu, cn);
  cr = __reduce_add_sync(0xffffffffu, cr);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    shf[warp] = m;
    shu[warp] = cn;
    shu[kWarps + warp] = cr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      m = fmaxf(m, shf[w]);
      cn += shu[w];
      cr += shu[kWarps + w];
    }
    slot[0] = __float_as_uint(m);
    slot[1] = cn;
    slot[2] = cr;
    shf[0] = m;
  }
  __syncthreads();
  // the block's max to every block too, for a signature on the same window
  if (threadIdx.x < k.K)
    k.slots<float>(max_off, threadIdx.x)[s.idx * k.K + k.rank] = shf[0];
  __syncthreads();  // shf, shu are reused
}

// preprocess: f x f area mean of the window, (v - 0.5) / 0.25 per channel,
// or the luminance of the three written to every channel (grey).  Each
// block writes the output rows of its own band of dst (an even split of
// the rows over the cluster).  It first gathers the source rows of those
// outputs, wherever they live, into its own shared memory (`gather`), every
// thread copying words at once, so the remote reads cost one latency; then
// it computes from the local copy.
template <typename E>
__device__ __forceinline__ float window_mean(const E* p, int pitch, int f) {
  if constexpr (std::is_same<E, uint8_t>::value) {
    unsigned sum = 0;  // exact integer sum, as fused_preprocess.cu
    for (int dy = 0; dy < f; ++dy)
      for (int dx = 0; dx < f; ++dx) sum += p[dy * pitch + dx];
    return pixel::area_mean((float)sum, f);
  } else {
    float sum = 0.0f;
    for (int dy = 0; dy < f; ++dy)
      for (int dx = 0; dx < f; ++dx) sum += p[dy * pitch + dx];
    return pixel::area_mean(sum, f);
  }
}

// Copy rows [y, y + rows) x columns [x, x + cols) of every channel of `in`
// to g (C, rows, cols), in words of V bytes.
template <int V, typename E>
__device__ __forceinline__ void gather_words(const Cta& k, const Bands<E>& in,
                                             int y, int x, int rows, int cols,
                                             E* g) {
  using Word = typename std::conditional<
      V == 16, uint4, typename std::conditional<V == 4, unsigned,
                                                uint8_t>::type>::type;
  const int words = cols * (int)sizeof(E) / V, n = k.C * rows * words;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int w = i % words, t = i / words, r = t % rows, c = t / rows;
    const Word* src = reinterpret_cast<const Word*>(in.row(y + r) +
                                                    c * in.cs + x);
    reinterpret_cast<Word*>(g + ((size_t)c * rows + r) * cols)[w] = src[w];
  }
}

template <typename E>
__device__ __forceinline__ void preprocess_stage(const Cta& k, const Stage& s,
                                                 const Bands<E>& in,
                                                 const Bands<float>& out,
                                                 E* g) {
  const int Wo = s.dst_w, f = s.factor, o0 = k.rank * out.band;
  const int rows = min(s.dst_h, o0 + out.band) - o0;
  __syncthreads();  // the gather area may be the predecessor's band
  if (rows > 0) {
    const int gy = s.y0 + o0 * f, gr = rows * f, gc = Wo * f;
    const int bytes_x = s.x0 * (int)sizeof(E), bytes_c = gc * (int)sizeof(E);
    const int pitch = s.src_w * (int)sizeof(E);
    if ((bytes_x | bytes_c | pitch) % 16 == 0)
      gather_words<16>(k, in, gy, s.x0, gr, gc, g);
    else if ((bytes_x | bytes_c | pitch) % 4 == 0)
      gather_words<4>(k, in, gy, s.x0, gr, gc, g);
    else
      gather_words<1>(k, in, gy, s.x0, gr, gc, g);
  }
  __syncthreads();
  const int n = (s.grey ? 1 : k.C) * max(rows, 0) * Wo;
  const int gr = rows * f, gc = Wo * f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ox = i % Wo, t = i / Wo, oy = t % rows, co = t / rows;
    const E* p = g + (size_t)oy * f * gc + ox * f;  // channel 0's window
    float* o = out.base + (size_t)oy * Wo + ox;
    if (!s.grey) {
      o[co * out.cs] = pixel::normalize(
          window_mean(p + (size_t)co * gr * gc, gc, f), 0.5f, 0.25f);
      continue;
    }
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = pixel::normalize(window_mean(p + (size_t)c * gr * gc, gc, f),
                              0.5f, 0.25f);
    const float lum = pixel::luma(v[0], v[1], v[2]);
    for (int c = 0; c < k.C; ++c) o[c * out.cs] = lum;
  }
  __syncthreads();  // g is reused by the next preprocess
}

// signature: (gy, gx) patch means per channel of the window; a window
// whose max is > 8 holds raw values and is normalized first.  Each block
// takes the patch rows whose first source row lies in its band.  The
// window's max comes from a colour stage on the same window (s.idx, the
// plan's choice) or from a pass over the block's rows, each block's max
// to slot (block) of every block; after a cluster.sync() every block
// combines them.  Then a thread sums a patch, dy then dx (eight loads
// issued before their adds), and writes its mean.
// sum += each of p[0, n), in order, normalized first when kRaw; eight
// loads are issued before their adds
template <bool kRaw, typename E>
__device__ __forceinline__ float add_row(const E* p, int n, float sum) {
  for (int x0 = 0; x0 < n; x0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = x0 + j < n ? (float)p[x0 + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (x0 + j < n) sum += kRaw ? (v[j] / 255.0f - 0.5f) / 0.25f : v[j];
  }
  return sum;
}

template <typename E>
__device__ __forceinline__ void signature_stage(const Cta& k, const Stage& s,
                                                const Bands<E>& in,
                                                float* feats, int slot_off,
                                                int color_max_off,
                                                float* shf) {
  const int gy = s.a, gx = s.b, ph = s.h / gy, pw = s.w / gx;
  const int2 r = owned(k.rank, s.src_band, s.y0, ph, gy);
  const int rows = r.y - r.x;
  if (s.idx < 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float m = -INFINITY;
    for (int t = warp; t < k.C * rows * ph; t += kWarps) {  // a warp a row
      const int y = t % (rows * ph), c = t / (rows * ph);
      const E* p = in.row(s.y0 + r.x * ph + y) + c * in.cs + s.x0;
      for (int x = lane; x < s.w; x += 32) m = fmaxf(m, (float)p[x]);
    }
    m = block_reduce(m, shf, Max());
    if (threadIdx.x < k.K) k.slots<float>(slot_off, threadIdx.x)[k.rank] = m;
  }
  mark(30);
  cg::this_cluster().sync();
  mark(31);
  const float* slot = reinterpret_cast<const float*>(
      k.smem + (s.idx < 0 ? slot_off : color_max_off)) +
      (s.idx < 0 ? 0 : s.idx * k.K);
  float m = -INFINITY;
  for (int q = 0; q < k.K; ++q) m = fmaxf(m, slot[q]);
  const bool raw = m > 8.0f;
  const float inv = 1.0f / (float)(ph * pw);
  for (int j = threadIdx.x; j < k.C * rows * gx; j += kThreads) {
    const int px = j % gx, t = j / gx, py = r.x + t % rows, c = t / rows;
    float sum = 0.0f;
    for (int dy = 0; dy < ph; ++dy) {
      const E* p = in.row(s.y0 + py * ph + dy) + c * in.cs + s.x0 + px * pw;
      sum = raw ? add_row<true>(p, pw, sum) : add_row<false>(p, pw, sum);
    }
    feats[((size_t)c * gy + py) * gx + px] = sum * inv;
  }
}

// copy: the final window to x (input type without a preprocess stage),
// the window rows whose source row lies in this block's band.
template <typename E>
__device__ __forceinline__ void copy_stage(const Cta& k, const Stage& s,
                                           const Bands<E>& in, E* out) {
  const int2 r = owned(k.rank, s.src_band, s.y0, 1, s.h);
  const int rows = r.y - r.x, n = k.C * rows * s.w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = i % s.w, t = i / s.w, y = r.x + t % rows, c = t / rows;
    out[((size_t)c * s.h + y) * s.w + x] =
        in.row(s.y0 + y)[c * in.cs + s.x0 + x];
  }
}

// After the last cluster.sync(): x's band to device memory, and block 0
// combines the diff's and the colours' partials in block order.
template <typename T>
__device__ __forceinline__ void finish(const Cta& k, const Spec& sp, float* d,
                                       float* fracs, void* x, int nreg) {
  if (sp.off[kOut] >= 0) {
    const int band = sp.x_band, Wo = sp.x_w, xh = sp.x_h, o0 = k.rank * band;
    const int rows = min(xh, o0 + band) - o0;
    const float* src = reinterpret_cast<const float*>(k.smem + sp.off[kOut]);
    float* out = static_cast<float*>(x);
    if (rows > 0 && Wo % 4 == 0) {
      const int words = rows * Wo / 4, n = k.C * words;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int c = i / words, j = i - c * words;
        reinterpret_cast<float4*>(out + ((size_t)c * xh + o0) * Wo)[j] =
            reinterpret_cast<const float4*>(src + (size_t)c * band * Wo)[j];
      }
    } else if (rows > 0) {
      const int chunk = rows * Wo, n = k.C * chunk;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int c = i / chunk, j = i - c * chunk;
        out[((size_t)c * xh + o0) * Wo + j] = src[(size_t)c * band * Wo + j];
      }
    }
  }
  for (int i = 0; i < sp.n; ++i) {
    const Stage s = sp.st[i];
    if (s.kind == kDiff && k.rank == 0) {
      using Acc = typename std::conditional<std::is_same<T, uint8_t>::value,
                                            unsigned, float>::type;
      const Acc* slot = reinterpret_cast<const Acc*>(k.smem + sp.diff_slots);
      const int rh = s.src_h / s.a, rw = s.src_w / s.b;
      for (int r = threadIdx.x; r < nreg; r += kThreads) {
        Acc tot = 0;
        for (int q = 0; q < k.K; ++q) tot += slot[r * k.K + q];
        d[r] = diffk::region_mean(tot, k.C, rh, rw);
      }
    } else if (s.kind == kColor && k.rank == 0 && threadIdx.x == 0) {
      const unsigned* slot =
          reinterpret_cast<const unsigned*>(k.smem + sp.color_slots) +
          3 * s.idx * k.K;
      float m = -INFINITY;
      for (int q = 0; q < k.K; ++q) m = fmaxf(m, __uint_as_float(slot[3 * q]));
      const int pick = m <= 8.0f ? 1 : 2;
      unsigned cnt = 0;
      for (int q = 0; q < k.K; ++q) cnt += slot[3 * q + pick];
      fracs[s.idx] = (float)cnt * (1.0f / (float)(s.h * s.w));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_prefix_kernel(const T* __restrict__ frames, const T* __restrict__ prevs,
                    float* d, float* fracs, void* x, float* feats, int C,
                    int H, int W, long long out_frame, int out_is_float,
                    int nreg, int ncolor, int sig_d, int vec,
                    const __grid_constant__ Spec spec) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float shf[kWarps];
  __shared__ unsigned shu[2 * kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = spec.blocks, in_off = spec.off[kInput];
  const int prev_off = spec.off[kPrev];
  const Cta k{smem, (int)cluster.block_rank(), K, C};
  const size_t b = blockIdx.x / K;
  const size_t in_frame = (size_t)C * H * W;
  const int band = (H + K - 1) / K;  // kernel.py band_rows
  mark(38, true);
  mark(37);  // the block's SM
  mark(0);
  load_band<T>(k, reinterpret_cast<T*>(smem + in_off), frames + b * in_frame,
               H, W, band, vec);
  if (prev_off >= 0)
    load_band<T>(k, reinterpret_cast<T*>(smem + prev_off),
                 prevs + b * in_frame, H, W, band, vec);
  mark(1);
  if (vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  mark(2);
  void* xo = out_is_float ? (void*)(static_cast<float*>(x) + b * out_frame)
                          : (void*)(static_cast<T*>(x) + b * out_frame);
  const int n = spec.n;
  for (int i = 0; i < n; ++i) {
    const Stage s = spec.st[i];
    if (s.sync) cluster.sync();
    mark(3 + 2 * i);
    const int so = spec.off[s.src];
    const bool raw_in = s.src == kInput;  // the input's type, else float
    switch (s.kind) {
      case kDiff:
        diff_stage<T>(k, s, in_off, prev_off, spec.diff_slots);
        break;
      case kColor: {
        unsigned* slot = k.slots<unsigned>(spec.color_slots, 0) +
                         3 * (s.idx * K + k.rank);
        const int max_off = spec.color_slots + 12 * ncolor * K;
        if (raw_in)
          color_stage(k, s, k.bands<T>(so, s.src_band, s.src_w), slot,
                      max_off, shf, shu);
        else
          color_stage(k, s, k.bands<float>(so, s.src_band, s.src_w), slot,
                      max_off, shf, shu);
        break;
      }
      case kPreprocess: {
        const Bands<float> out =
            k.bands<float>(spec.off[s.dst], s.dst_band, s.dst_w);
        if (raw_in)
          preprocess_stage(k, s, k.bands<T>(so, s.src_band, s.src_w), out,
                           reinterpret_cast<T*>(smem + spec.gather));
        else
          preprocess_stage(k, s, k.bands<float>(so, s.src_band, s.src_w),
                           out, reinterpret_cast<float*>(smem + spec.gather));
        break;
      }
      case kSignature: {
        const int max_off = spec.color_slots + 12 * ncolor * K;
        if (raw_in)
          signature_stage(k, s, k.bands<T>(so, s.src_band, s.src_w),
                          feats + b * sig_d, spec.sig_slots, max_off, shf);
        else
          signature_stage(k, s, k.bands<float>(so, s.src_band, s.src_w),
                          feats + b * sig_d, spec.sig_slots, max_off, shf);
        break;
      }
      default:
        if (raw_in)
          copy_stage(k, s, k.bands<T>(so, s.src_band, s.src_w),
                     static_cast<T*>(xo));
        else
          copy_stage(k, s, k.bands<float>(so, s.src_band, s.src_w),
                     static_cast<float*>(xo));
    }
    mark(4 + 2 * i);
  }
  cluster.sync();  // every band and slot written; no remote access after
  mark(35);
  finish<T>(k, spec, d ? d + b * nreg : nullptr,
            fracs ? fracs + b * ncolor : nullptr, xo, nreg);
  mark(36);
  mark(39, true);
}

template <typename T>
cudaLaunchConfig_t config(const Spec& spec, int B, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * spec.blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)spec.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)spec.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a cluster's blocks on as many SMs as the card has free, not packed
  // several to an SM where shared memory would let them
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

template <typename T>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(fused_prefix_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int launch(const void* frames, const void* prevs, void* d, void* fracs,
           void* x, void* feats, int B, int C, int H, int W,
           long long out_frame, int out_is_float, int nreg, int ncolor,
           int sig_d, int vec, const Spec& spec, cudaStream_t st) {
  cudaError_t e = allow_smem<T>(spec.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = config<T>(spec, B, st, attr);
  e = cudaLaunchKernelEx(&cfg, fused_prefix_kernel<T>, (const T*)frames,
                         (const T*)prevs, (float*)d, (float*)fracs, x,
                         (float*)feats, C, H, W, out_frame, out_is_float,
                         nreg, ncolor, sig_d, vec, spec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool valid(const Spec* spec) {
  return spec != nullptr && spec->n > 0 && spec->n <= prefix::kMaxStages &&
         spec->blocks >= 1 && spec->blocks <= 8 && spec->smem > 0 &&
         spec->off[kInput] >= 0;
}

}  // namespace

// frames, prevs (B, C, H, W) uint8 (is_float 0) or float32 (1), contiguous;
// prevs only with a diff stage.  Outputs: d (B, nreg), fracs (B, ncolor),
// x (B, out_frame) float32 when out_is_float else the input type, feats
// (B, sig_d); any may be null when no stage writes it.  `spec` (the
// cluster plan) is read on the host at launch.  One launch of B clusters
// of spec->blocks blocks; a launch the card refuses returns its error.
extern "C" int fused_prefix_launch(const void* frames, const void* prevs,
                                   int is_float, void* d, void* fracs, void* x,
                                   void* feats, int B, int C, int H, int W,
                                   long long out_frame, int out_is_float,
                                   int nreg, int ncolor, int sig_d,
                                   const Spec* spec, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || !valid(spec) || x == nullptr ||
      (spec->off[kPrev] >= 0 && prevs == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t item = is_float ? 4 : 1;
  const int vec = (W * item) % 16 == 0 && (uintptr_t)frames % 16 == 0 &&
                  (prevs == nullptr || (uintptr_t)prevs % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_float)
    return launch<float>(frames, prevs, d, fracs, x, feats, B, C, H, W,
                         out_frame, out_is_float, nreg, ncolor, sig_d, vec,
                         *spec, st);
  return launch<uint8_t>(frames, prevs, d, fracs, x, feats, B, C, H, W,
                         out_frame, out_is_float, nreg, ncolor, sig_d, vec,
                         *spec, st);
}

#ifdef FUSED_PREFIX_PROBE
// The probe build's marks buffer: int64 (launched blocks, kMarks), or null.
extern "C" int fused_prefix_probe(void* marks) {
  return (int)cudaMemcpyToSymbol(probe_marks, &marks, sizeof(marks));
}
#endif

// How many clusters of `spec` the card runs at once
// (cudaOccupancyMaxActiveClusters).  No launch.
extern "C" int fused_prefix_occupancy(int is_float, const Spec* spec,
                                      int* clusters) {
  if (!valid(spec)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  cudaError_t e;
  if (is_float) {
    e = allow_smem<float>(spec->smem);
    if (e != cudaSuccess) return (int)e;
    const cudaLaunchConfig_t cfg = config<float>(*spec, 1, nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(clusters, fused_prefix_kernel<float>,
                                       &cfg);
  } else {
    e = allow_smem<uint8_t>(spec->smem);
    if (e != cudaSuccess) return (int)e;
    const cudaLaunchConfig_t cfg = config<uint8_t>(*spec, 1, nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(clusters,
                                       fused_prefix_kernel<uint8_t>, &cfg);
  }
  return (int)e;
}
