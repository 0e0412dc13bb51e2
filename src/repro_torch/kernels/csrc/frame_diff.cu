// frame_diff.cu: per-region mean |cur - prev| / 255 (the Skip operator's
// activity signal).
//
// Replaces: src/repro/kernels/frame_diff/kernel.py, frame_diff_kernel
// (Pallas body _diff_kernel, one program per (frame, region)).
//
// Bound on an H100: bytes.  The function reads 2*B*C*H*W bytes once and
// does three integer operations per byte pair, far below the card's
// operations-per-byte ridge.  At the Skip operator's shape (B=16, 3x128x256,
// regions 4x8) that is 3.1 MB, about 0.94 us at 3.35 TB/s, so the launch
// itself costs more than the traffic.
//
// Design: the kernel is latency-bound, so a region takes as few dependent
// steps as it can.  One warp sums a region (wpr warps where a region holds
// more than a warp's batch, wpr in 1, 2, 4); each lane issues the loads of
// all its 16-byte pairs (up to kBatch) before it adds any, then one shuffle
// tree gives the region's sum: at the Skip shape a region is 192 pairs, six
// a lane, one batch, and no shared memory or __syncthreads.  A block of four
// warps holds 4 / wpr regions, so the Skip shape's 512 regions are 128
// blocks, one for nearly every SM.  Rows that are not 16-byte aligned take
// byte loads.  The arithmetic (lane sums, exact 32-bit integer sums, one
// division for the mean) is diff.cuh's, which fused_prefix.cu shares.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/pixel_compare.py,
// recorded in PERF.md): 0.0035 ms at the Skip shape, against 0.0040 for
// the earlier design (a block of 256 threads a region) and 0.0019 for an
// empty kernel on the same grid.
#include <cuda_runtime.h>
#include <stdint.h>

#include "diff.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 8;  // pairs a lane keeps in flight

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
frame_diff_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ prev, float* __restrict__ out,
                  int nreg, int C, int H, int W, int RY, int RX, int wpr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kWarps / wpr) + warp / wpr;  // (b, ry, rx)
  const int part = warp % wpr;
  const int rh = H / RY, rw = W / RX;
  unsigned acc = 0;
  if (r < nreg) {  // uniform over the warp
    const int rx = r % RX, ry = (r / RX) % RY, b = r / (RX * RY);
    const size_t frame = (size_t)b * C * H * W;
    const size_t base = frame + (size_t)ry * rh * W + (size_t)rx * rw;
    const int first = part * 32 + lane, stride = 32 * wpr;
    const diffk::Region reg{cur + base, prev + base, C, rh,
                            kVec ? rw / 16 : rw, (size_t)H * W, (size_t)W};
    if constexpr (kVec)
      acc = diffk::lane_sum<true, uint4, unsigned, kBatch>(reg, first, stride);
    else
      acc = diffk::lane_sum<true, uint8_t, unsigned, kBatch>(reg, first,
                                                             stride);
  }
  acc = diffk::warp_sum(acc);
  if (wpr == 1) {
    if (r < nreg && lane == 0) out[r] = diffk::region_mean(acc, C, rh, rw);
    return;
  }
  __shared__ unsigned parts[kWarps];
  if (lane == 0) parts[warp] = acc;
  __syncthreads();
  if (r < nreg && part == 0 && lane == 0) {
    unsigned tot = 0;
    for (int k = 0; k < wpr; ++k) tot += parts[warp + k];
    out[r] = diffk::region_mean(tot, C, rh, rw);
  }
}

}  // namespace

// cur/prev (B, C, H, W) uint8, contiguous; out (B, RY, RX) float32.
extern "C" int frame_diff_u8(const void* cur, const void* prev, void* out,
                             int B, int C, int H, int W, int RY, int RX,
                             void* stream) {
  if (B <= 0 || C <= 0 || RY <= 0 || RX <= 0 || H % RY || W % RX)
    return (int)cudaErrorInvalidValue;
  const int rh = H / RY, rw = W / RX;
  if ((double)C * rh * rw * 255.0 > 4294967295.0)
    return (int)cudaErrorInvalidValue;  // the 32-bit sum would overflow
  const bool vec = (rw % 16 == 0) && (W % 16 == 0) &&
                   ((uintptr_t)cur % 16 == 0) && ((uintptr_t)prev % 16 == 0);
  // warps a region: the fewest (1, 2, 4) that keep a lane to one batch
  const long long items = (long long)C * rh * (vec ? rw / 16 : rw);
  int wpr = 1;
  while (wpr < kWarps && items > 32LL * wpr * kBatch) wpr *= 2;
  const long long nreg = (long long)B * RY * RX;
  const long long blocks = (nreg + kWarps / wpr - 1) / (kWarps / wpr);
  if (nreg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    frame_diff_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)cur, (const uint8_t*)prev, (float*)out, (int)nreg, C,
        H, W, RY, RX, wpr);
  else
    frame_diff_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)cur, (const uint8_t*)prev, (float*)out, (int)nreg, C,
        H, W, RY, RX, wpr);
  return (int)cudaGetLastError();
}
