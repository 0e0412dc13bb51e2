"""Time three ways of loading a decode tick's K/V rows into shared memory.

    python scripts/decode_loader_probe.py        # on a CUDA host (nvcc)

decode_attention_bf16 reads, for each block, a split of one sequence's
live keys from the model's (B, S, Hk, D) bf16 cache, where one key's D
values of K (and of V) are contiguous and the next key's are Hk * D
further on.  This script streams exactly those rows, stage by stage (64
keys a stage, a ring of stages in shared memory), and does no arithmetic,
so that the loaders' own cost shows:

  bulk      one producer warp copies each row with TMA's 1-D bulk copy
            (``cp.async.bulk``, 2 * D bytes) onto the stage's full
            mbarrier (expect_tx); eight consumer warps wait on it and
            release the stage on its empty mbarrier;
  producer  the same producer warp and mbarriers, 16-byte ``cp.async``
            over the warp's lanes, the arrivals by
            ``cp.async.mbarrier.arrive.noinc``;
  warps     every one of eight warps copies its own 8 rows of each stage
            with 16-byte ``cp.async`` and waits for its own copies
            (``cp.async.wait_group``): no mbarrier, no block barrier
            (decode_attention_bf16.cu's loader).

The grids are the kernel's at the served ticks on an H100 (132 SMs):
chatglm3-6b's long slot (2 kv heads of 128, 66 blocks a head of 64 keys),
gemma2-2b's (4 kv heads of 256, 24 blocks of 176), phi3-mini's (32 kv
heads of 96, 4 blocks of 1056) and moonshot-v1-16b-a3b's (16 kv heads of
128, 12 blocks of 352).  Each loader's device time (``chip_smoke.
device_ms``) is printed in turns, with the card's name and power limit.
The library is built into ``build/probe`` (gitignored).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper.cuh"

constexpr int kWarps = 8, kGroup = 8, kStage = kWarps * kGroup;

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void bulk(uint32_t dst, const void* src,
                                     uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// block (x, hk) streams keys [x * n, x * n + n) of sequence 0, kv head hk,
// of k and v (S, Hk, D) into a ring of NS stages; *sink keeps the reads
template <int MODE, int D, int NS>
__global__ void __launch_bounds__(32 * (kWarps + (MODE < 2)))
stream(const uint16_t* k, const uint16_t* v, int Hk, int n, int* sink) {
  constexpr int L = D + 8, kChunks = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)Hk * D;
  const size_t base = (size_t)blockIdx.y * D + (size_t)blockIdx.x * n * row;
  const int nst = (n + kStage - 1) / kStage;
  auto at = [&](int s) { return ring + (size_t)(s % NS) * kStage * 2 * L; };
  if (MODE == 2) {
    auto load = [&](int s) {
      const int j0 = s * kStage + warp * kGroup;
      if (s >= nst || j0 >= n) return;
      uint16_t* ks = at(s) + warp * kGroup * L;
      uint16_t* vs = ks + kStage * L;
      for (int e = lane; e < kGroup * kChunks; e += 32) {
        const int j = e / kChunks, c = (e % kChunks) * 8;
        if (j0 + j >= n) continue;
        const size_t off = base + (size_t)(j0 + j) * row + c;
        cp16(hopper::smem_addr(ks + j * L + c), k + off);
        cp16(hopper::smem_addr(vs + j * L + c), v + off);
      }
    };
    int acc = 0;
    for (int s = 0; s < NS - 1; ++s) {
      load(s);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    for (int s = 0; s < nst; ++s) {
      asm volatile("cp.async.wait_group %0;" ::"n"(NS - 2) : "memory");
      __syncwarp();
      load(s + NS - 1);
      asm volatile("cp.async.commit_group;" ::: "memory");
      acc += at(s)[(warp * kGroup + (lane & 7)) * L];
    }
    if (acc == 12345) *sink = acc;
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(hopper::smem_addr(&full[s]), MODE == 0 ? 1 : 33);
      hopper::mbar_init(hopper::smem_addr(&empty[s]), kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (warp == kWarps) {
    for (int s = 0; s < nst; ++s) {
      const int slot = s % NS, j0 = s * kStage, nv = min(kStage, n - j0);
      if (s >= NS)
        hopper::mbar_wait(hopper::smem_addr(&empty[slot]), (s / NS - 1) & 1);
      uint16_t* ks = at(s);
      uint16_t* vs = ks + kStage * L;
      const uint32_t bar = hopper::smem_addr(&full[slot]);
      if (MODE == 0) {
        if (lane == 0) hopper::mbar_expect_tx(bar, 4u * D * nv);
        __syncwarp();
        for (int j = lane; j < nv; j += 32) {
          const size_t off = base + (size_t)(j0 + j) * row;
          bulk(hopper::smem_addr(ks + j * L), k + off, 2 * D, bar);
          bulk(hopper::smem_addr(vs + j * L), v + off, 2 * D, bar);
        }
      } else {
        for (int e = lane; e < nv * kChunks; e += 32) {
          const int j = e / kChunks, c = (e % kChunks) * 8;
          const size_t off = base + (size_t)(j0 + j) * row + c;
          cp16(hopper::smem_addr(ks + j * L + c), k + off);
          cp16(hopper::smem_addr(vs + j * L + c), v + off);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                     ::"r"(bar) : "memory");
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bar);
      }
    }
    return;
  }
  int acc = 0;
  for (int s = 0; s < nst; ++s) {
    hopper::mbar_wait(hopper::smem_addr(&full[s % NS]), (s / NS) & 1);
    acc += at(s)[(warp * kGroup + (lane & 7)) * L];
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(hopper::smem_addr(&empty[s % NS]));
  }
  if (acc == 12345) *sink = acc;
}

template <int MODE, int D, int NS>
int run(const void* k, const void* v, int Hk, int blocks, int n, int* sink,
        cudaStream_t st) {
  const size_t smem = (size_t)NS * kStage * 2 * (D + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      stream<MODE, D, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  stream<MODE, D, NS><<<dim3(blocks, Hk), 32 * (kWarps + (MODE < 2)), smem,
                        st>>>((const uint16_t*)k, (const uint16_t*)v, Hk, n,
                              sink);
  return (int)cudaGetLastError();
}

template <int MODE>
int by_d(const void* k, const void* v, int Hk, int D, int blocks, int n,
         int* sink, cudaStream_t st) {
  switch (D) {
    case 96: return run<MODE, 96, 4>(k, v, Hk, blocks, n, sink, st);
    case 128: return run<MODE, 128, 3>(k, v, Hk, blocks, n, sink, st);
    case 256: return run<MODE, 256, 2>(k, v, Hk, blocks, n, sink, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int loader(int mode, const void* k, const void* v, int Hk, int D,
                      int blocks, int n, void* sink, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* s = (int*)sink;
  switch (mode) {
    case 0: return by_d<0>(k, v, Hk, D, blocks, n, s, st);
    case 1: return by_d<1>(k, v, Hk, D, blocks, n, s, st);
    case 2: return by_d<2>(k, v, Hk, D, blocks, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""

#: (kv heads, head dim, blocks a kv head, keys a block): the kernel's grid
#: at each served long tick's long slot
TICKS = {"chatglm3": (2, 128, 66, 64), "gemma2": (4, 256, 24, 176),
         "phi3": (32, 96, 4, 1056), "moonshot": (16, 128, 12, 352)}
MODES = ("bulk", "producer", "warps")


def main() -> int:
    import chip_smoke as cs
    import torch

    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc

    if not torch.cuda.is_available():
        print("decode_loader_probe: needs a CUDA card", file=sys.stderr)
        return 1
    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    src, lib_path = (os.path.join(out, f"decode_loader.{x}")
                     for x in ("cu", "so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", lib_path,
                    src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).loader
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    print(f"card: {cs.smi_line()}")
    dev = torch.device("cuda")
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    times = {}
    for name, (hk, d, blocks, n) in TICKS.items():
        k, v = (torch.randn(blocks * n, hk, d, device=dev).to(torch.bfloat16)
                for _ in range(2))

        def call(mode):
            rc = fn(mode, k.data_ptr(), v.data_ptr(), hk, d, blocks, n,
                    sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"loader {MODES[mode]} {name}: CUDA error {rc}")

        for turn in (0, 1, 2, 2, 1, 0):
            times.setdefault(name, {}).setdefault(MODES[turn], []).append(
                cs.device_ms(lambda: call(turn)))
        mb = 2 * blocks * hk * n * d * 2 / 1e6
        print(f"{name} (Hk {hk}, D {d}, {blocks} blocks a head of {n} keys, "
              f"{mb:.1f} MB): " + ", ".join(
                  f"{m} {t[0]:.4f}/{t[1]:.4f} ms"
                  for m, t in times[name].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
