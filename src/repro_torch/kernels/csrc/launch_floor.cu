// launch_floor.cu: an empty kernel, the yardstick of the small kernels.
//
// A launch of it costs what any launch costs before its first instruction
// does work: the launch floor.  chip_smoke.py and scripts/pixel_compare.py
// time it with the grid of each pixel kernel (frame_diff's blocks, the
// fused_preprocess blocks, fused_prefix's clusters) and print it beside
// that kernel's time and bound.  The port never calls it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// `blocks` blocks of `threads` threads, in clusters of `cluster` blocks
// (1: no cluster; `blocks` a multiple of it).
extern "C" int empty_launch(int blocks, int threads, int cluster,
                            void* stream) {
  if (blocks <= 0 || threads <= 0 || cluster <= 0 || blocks % cluster)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
