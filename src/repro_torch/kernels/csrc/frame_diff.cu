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
// Design: one block per (frame, region).  The block walks the C*rh*rw byte
// pairs with 16-byte loads where the region rows are 16-byte aligned
// (__vsadu4 sums four absolute byte differences in one instruction) and
// byte loads otherwise.  Partial sums are 32-bit integers, so the sum is
// exact; a warp-shuffle tree and one shared-memory step reduce them, and a
// single division turns the sum into the mean.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
frame_diff_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ prev, float* __restrict__ out,
                  int C, int H, int W, int RY, int RX, int vec) {
  const int rx = blockIdx.x % RX;
  const int ry = (blockIdx.x / RX) % RY;
  const int b = blockIdx.x / (RX * RY);
  const int rh = H / RY, rw = W / RX;
  const size_t frame = (size_t)b * C * H * W;
  const int y0 = ry * rh, x0 = rx * rw;
  unsigned acc = 0;
  if (vec) {
    const int vw = rw / 16;  // 16-byte words per region row
    const int n = C * rh * vw;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int xv = i % vw, t = i / vw, y = t % rh, c = t / rh;
      const size_t off = frame + ((size_t)c * H + y0 + y) * W + x0 + xv * 16;
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(cur + off));
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(prev + off));
      acc += __vsadu4(a.x, p.x) + __vsadu4(a.y, p.y) + __vsadu4(a.z, p.z) +
             __vsadu4(a.w, p.w);
    }
  } else {
    const int n = C * rh * rw;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int x = i % rw, t = i / rw, y = t % rh, c = t / rh;
      const size_t off = frame + ((size_t)c * H + y0 + y) * W + x0 + x;
      acc += (unsigned)abs((int)cur[off] - (int)prev[off]);
    }
  }
  __shared__ unsigned partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    unsigned v = lane < kThreads / 32 ? partial[lane] : 0u;
    v = warp_sum(v);
    if (lane == 0)
      out[blockIdx.x] = (float)((double)v / (255.0 * (double)C * rh * rw));
  }
}

}  // namespace

// cur/prev (B, C, H, W) uint8, contiguous; out (B, RY, RX) float32.
extern "C" int frame_diff_u8(const void* cur, const void* prev, void* out,
                             int B, int C, int H, int W, int RY, int RX,
                             void* stream) {
  if (B <= 0 || RY <= 0 || RX <= 0 || H % RY || W % RX)
    return (int)cudaErrorInvalidValue;
  const int rh = H / RY, rw = W / RX;
  if ((double)C * rh * rw * 255.0 > 4294967295.0)
    return (int)cudaErrorInvalidValue;  // the 32-bit sum would overflow
  const int vec = (rw % 16 == 0) && (W % 16 == 0) &&
                  ((uintptr_t)cur % 16 == 0) && ((uintptr_t)prev % 16 == 0);
  frame_diff_kernel<<<B * RY * RX, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)prev, (float*)out, C, H, W, RY, RX,
      vec);
  return (int)cudaGetLastError();
}
