// diff.cuh: the arithmetic of frame differencing, shared by frame_diff.cu
// and fused_prefix.cu, so that Skip's activity values (and its keep
// decisions) in a fused plan equal its unfused twin's by construction.
//
// A region's sum of |cur - prev| is taken by lanes that each walk a strided
// share of its items: 16-byte words of uint8 pairs (__vsadu4 sums four
// absolute byte differences in one instruction), single bytes where the
// region's rows are not 16-byte aligned, or floats.  A lane issues the
// loads of kBatch items before it adds any, so a region costs one memory
// latency a batch, not one an item.  uint8 sums are 32-bit integers, so the
// sum is exact whatever the split; the mean is one division in double.
#pragma once

#include <stdint.h>

namespace diffk {

// |a - b| summed over the 16 bytes of two words
__device__ __forceinline__ unsigned sad(const uint4& a, const uint4& b) {
  return __vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) + __vsadu4(a.z, b.z) +
         __vsadu4(a.w, b.w);
}
__device__ __forceinline__ unsigned sad(uint8_t a, uint8_t b) {
  return (unsigned)abs((int)a - (int)b);
}
__device__ __forceinline__ float sad(float a, float b) { return fabsf(a - b); }

template <bool kGlobal, typename Word>
__device__ __forceinline__ Word load(const Word* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

// A region of a cur/prev pair: C x rows x cols items (Word: a 16-byte
// word, a byte or a float), item (c, y, x) at byte offset
// c * cs + y * rs + x * sizeof(Word) of cur and of prev.
struct Region {
  const uint8_t* cur;
  const uint8_t* prev;
  int C, rows, cols;
  size_t cs, rs;
};

// One lane's share of a region: items first, first + stride, ... in
// (c, y, x) order (global memory through the read-only cache when kGlobal,
// else shared memory).  The lane walks its items by adding the stride's
// (rows, cols) to its position, a division only where it crosses a
// channel, and issues kBatch items' loads before it adds any.
template <bool kGlobal, typename Word, typename Acc, int kBatch>
__device__ __forceinline__ Acc lane_sum(const Region& r, int first,
                                        int stride) {
  int x = first % r.cols, t = first / r.cols, y = t % r.rows, c = t / r.rows;
  const int sx = stride % r.cols, sy = stride / r.cols;
  Acc acc = 0;
  while (c < r.C) {
    Word a[kBatch], p[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      a[j] = p[j] = Word{};
      if (c < r.C) {
        const size_t o = c * r.cs + y * r.rs + x * sizeof(Word);
        a[j] = load<kGlobal>(reinterpret_cast<const Word*>(r.cur + o));
        p[j] = load<kGlobal>(reinterpret_cast<const Word*>(r.prev + o));
        x += sx;
        if (x >= r.cols) {
          x -= r.cols;
          ++y;
        }
        y += sy;
        if (y >= r.rows) {
          const int q = y / r.rows;
          c += q;
          y -= q * r.rows;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += sad(a[j], p[j]);
  }
  return acc;
}

// Sum over the 32 lanes of a warp, in a fixed order; every lane gets it.
template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A region's mean |cur - prev| / 255 from its sum over C x rh x rw pairs.
template <typename Acc>
__device__ __forceinline__ float region_mean(Acc sum, int C, int rh, int rw) {
  return (float)((double)sum / (255.0 * (double)C * rh * rw));
}

}  // namespace diffk
