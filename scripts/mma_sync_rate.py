"""The card's mma.sync rates, the ceiling of the port's tensor-core kernels.

    python scripts/mma_sync_rate.py        # on a CUDA host with nvcc

flash_attention runs ``mma.sync.m16n8k8`` on TF32 operands and
int8_matmul's tensor-core route ``mma.sync.m16n8k32`` on int8 ones; the
data-sheet peaks (495 TFLOP/s TF32, 1979 TOP/s int8) are wgmma's.  This
builds one small kernel per instruction (``build/mma_sync_rate``, gitignored)
and times it on register operands, no memory traffic: with 8 independent
accumulators a warp (the rate) and with one (a dependent chain: the
latency), at 4, 8 and 16 warps per SM.  Prints one line per case and the
card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels._build import NVCC_FLAGS, nvcc  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
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
template <int CH, bool S8>
__global__ void bench(float* out, int iters, uint32_t a) {
  float cf[CH][4] = {};
  int ci[CH][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (S8) mma_s8(ci[j], a, a + j); else mma_tf32(cf[j], a, a + j);
    }
  float s = 0.0f;
  for (int j = 0; j < CH; ++j)
    for (int e = 0; e < 4; ++e) s += cf[j][e] + (float)ci[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int chains, int s8, int blocks, int iters, float* out,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t a = s8 ? 0x01010101u : 0x3f800000u;
  if (s8) {
    if (chains == 1) bench<1, true><<<blocks, 128, 0, st>>>(out, iters, a);
    else bench<8, true><<<blocks, 128, 0, st>>>(out, iters, a);
  } else {
    if (chains == 1) bench<1, false><<<blocks, 128, 0, st>>>(out, iters, a);
    else bench<8, false><<<blocks, 128, 0, st>>>(out, iters, a);
  }
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
    subprocess.run([nvcc(), *NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for s8, name, ops in ((0, "tf32 m16n8k8", 16 * 8 * 8 * 2),
                          (1, "int8 m16n8k32", 16 * 8 * 32 * 2)):
        for chains in (8, 1):
            for warps in (4, 8, 16):
                blocks, iters = sms * warps // 4, 4096
                assert fn(chains, s8, blocks, 16, buf.data_ptr(), stream) == 0
                a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
                a.record()
                fn(chains, s8, blocks, iters, buf.data_ptr(), stream)
                b.record()
                torch.cuda.synchronize()
                ms = a.elapsed_time(b)
                n = blocks * 4 * iters * chains
                print(f"{name}: {chains} accumulator(s) a warp, {warps} warps "
                      f"per SM: {n * ops / ms / 1e9:.1f} T/s, "
                      f"{ms * 1e6 / (n / (sms * 4)):.3f} ns per mma per SM "
                      "sub-partition")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
