// preprocess.cuh: the per-output arithmetic of crop + area mean +
// normalize (+ luminance), shared by fused_preprocess.cu and
// fused_prefix.cu so that the two kernels write bitwise equal frames.
#pragma once

namespace pixel {

// Mean of an f x f window of raw values given their sum.
__device__ __forceinline__ float area_mean(float sum, int f) {
  return (sum / 255.0f) / (float)(f * f);
}

__device__ __forceinline__ float normalize(float v, float mean, float std) {
  return (v - mean) / std;
}

// 0.299 r + 0.587 g + 0.114 b of three normalized channels.  Every product
// and sum is rounded on its own (no fused multiply-add), in the order the
// plain PyTorch version computes them.
__device__ __forceinline__ float luma(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(b, 0.114f));
}

}  // namespace pixel
