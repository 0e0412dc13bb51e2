"""The card's tensor-core rates, the ceiling of the port's kernels.

    python scripts/mma_sync_rate.py        # on a CUDA host with nvcc

flash_attention runs ``mma.sync.m16n8k8`` on TF32 operands, int8_matmul's
tensor-core route ``mma.sync.m16n8k32`` on int8 ones, decode_attention's
bf16 kernel ``mma.sync.m16n8k16`` on bf16 ones, and flash_attention's
bf16 kernel ``wgmma.mma_async.m64n128k16`` (bf16, operands in shared
memory for Q.K^T); the data-sheet peaks (495 TFLOP/s TF32, 1979 TOP/s
int8, 989 TFLOP/s bf16) are wgmma's.  This builds one small kernel per
instruction (``build/mma_sync_rate``, gitignored) and times it with no
memory traffic: mma.sync on register operands with 8 independent
accumulators a warp (the rate) and with one (a dependent chain: the
latency), at 4, 8 and 16 warps per SM; wgmma on zeroed shared-memory
tiles (``csrc/hopper.cuh``'s wrapper and descriptors), 8 products into
one accumulator a commit group, at 1 and 2 warpgroups per SM.  Prints one
line per case and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper.cuh"
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a), "r"(b));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};"
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]) : "r"(a), "r"(b));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a), "r"(b));
}
// MODE 0 tf32, 1 int8, 2 bf16
template <int CH, int MODE>
__global__ void bench(float* out, int iters, uint32_t a) {
  float cf[CH][4] = {};
  int ci[CH][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (MODE == 1) mma_s8(ci[j], a, a + j);
      else if (MODE == 2) mma_bf16(cf[j], a, a + j);
      else mma_tf32(cf[j], a, a + j);
    }
  float s = 0.0f;
  for (int j = 0; j < CH; ++j)
    for (int e = 0; e < 4; ++e) s += cf[j][e] + (float)ci[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// wgmma.m64n128k16 bf16: A 64 x 64 and B 128 x 64 in shared memory
// (K-major, 128-byte swizzle, zeros), 8 products a commit group (two k
// steps of each 64-wide tile, 4 tiles), one fp32 accumulator a warpgroup
__global__ void __launch_bounds__(256) wgmma_bench(float* out, int iters) {
  using namespace hopper;
  __shared__ __align__(1024) unsigned char sm[8192 + 16384];
  for (int i = threadIdx.x; i < (8192 + 16384) / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(sm)[i] = 0u;
  __syncthreads();
  const uint32_t a = smem_addr(sm);
  const uint64_t da = descriptor(a, 16, 1024, 1);
  const uint64_t db = descriptor(a + 8192, 16, 1024, 1);
  float d[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) d[e] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k)
      wgmma_ss<128>(d, da + 2 * (k % 4), db + 2 * (k % 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < 64; ++e) s += d[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int chains, int mode, int blocks, int iters, float* out,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t a = mode == 1 ? 0x01010101u : mode == 2 ? 0x3f803f80u
                                                          : 0x3f800000u;
  if (mode == 0) {
    if (chains == 1) bench<1, 0><<<blocks, 128, 0, st>>>(out, iters, a);
    else bench<8, 0><<<blocks, 128, 0, st>>>(out, iters, a);
  } else if (mode == 1) {
    if (chains == 1) bench<1, 1><<<blocks, 128, 0, st>>>(out, iters, a);
    else bench<8, 1><<<blocks, 128, 0, st>>>(out, iters, a);
  } else {
    if (chains == 1) bench<1, 2><<<blocks, 128, 0, st>>>(out, iters, a);
    else bench<8, 2><<<blocks, 128, 0, st>>>(out, iters, a);
  }
  return (int)cudaGetLastError();
}
// warpgroups (1 or 2) a block, one block an SM
extern "C" int run_wgmma(int warpgroups, int blocks, int iters, float* out,
                         void* stream) {
  wgmma_bench<<<blocks, 128 * warpgroups, 0, (cudaStream_t)stream>>>(out,
                                                                     iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_sync_rate: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "mma_sync_rate")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, n) for n in ("rate.cu", "librate.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    wg = ctypes.CDLL(lib).run_wgmma
    wg.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(launch):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        a.record()
        launch()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    for mode, name, ops in ((0, "tf32 m16n8k8", 16 * 8 * 8 * 2),
                            (1, "int8 m16n8k32", 16 * 8 * 32 * 2),
                            (2, "bf16 m16n8k16", 16 * 8 * 16 * 2)):
        for chains in (8, 1):
            for warps in (4, 8, 16):
                blocks, iters = sms * warps // 4, 4096
                assert fn(chains, mode, blocks, 16, buf.data_ptr(),
                          stream) == 0
                ms = timed(lambda: fn(chains, mode, blocks, iters,
                                      buf.data_ptr(), stream))
                n = blocks * 4 * iters * chains
                print(f"{name}: {chains} accumulator(s) a warp, {warps} warps "
                      f"per SM: {n * ops / ms / 1e9:.1f} T/s, "
                      f"{ms * 1e6 / (n / (sms * 4)):.3f} ns per mma per SM "
                      "sub-partition")
    ops = 64 * 128 * 16 * 2
    for groups in (1, 2):
        iters = 4096
        assert wg(groups, sms, 16, buf.data_ptr(), stream) == 0
        ms = timed(lambda: wg(groups, sms, iters, buf.data_ptr(), stream))
        n = sms * groups * iters * 8
        print(f"bf16 wgmma.m64n128k16 (shared-memory operands): {groups} "
              f"warpgroup(s) per SM: {n * ops / ms / 1e9:.1f} TFLOP/s, "
              f"{ms * 1e6 / (n / sms):.3f} ns per wgmma per SM")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
