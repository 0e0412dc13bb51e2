// bf16.cuh: bf16 tensor-core products with fp32 accumulators, shared by
// decode_attention_bf16.cu (the mma.sync m16n8k16 bf16 products,
// ldmatrix's transposed loads of a row-major V tile as the B operand of
// P.V) and flash_attention.cu (flash_attention_bf16, on wgmma: P's
// packing), and the packing of two fp32 values into a bf16x2 register.
//
// The product of two bf16 values is exact in fp32 (8 + 8 significant bits),
// so a bf16 mma differs from an fp32 dot of the same values only in how it
// sums.  An fp32 value p packs as its bf16 rounding hi and the bf16 rounding
// of the rest, lo = bf16(p - hi): hi + lo keeps about 16 of p's bits, so
// P.V as hi.V + lo.V (V exact in bf16) stays within ~2^-17 of fp32's P.V.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16", .bf16):
// lane = 4 * g + t.  A (16 x 16, row): register 0
// holds A[g][2t, 2t+1], 1 A[g+8][2t, 2t+1], 2 A[g][2t+8, 2t+9], 3
// A[g+8][2t+8, 2t+9] (the lower column in the low half).  B (16 x 8, col):
// register 0 holds B[2t, 2t+1][g], 1 B[2t+8, 2t+9][g].  C (16 x 8, fp32):
// c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].  So two adjacent
// accumulator tiles of S (16 rows x 8 keys each) are, packed pairwise, the
// A operand of P.V over those 16 keys (k16): no shuffle.  wgmma's
// accumulator and register A operand are these layouts a warp
// (hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;

// {lo, hi} -> one register, lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p0, p1 -> their bf16 roundings (hi) and the bf16 roundings of the rests
// (lo), each pair packed: one conversion a pair for each part, hi's values
// back to fp32 by a shift and a mask
__device__ __forceinline__ void pack_split(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack(p0, p1);
  lo = pack(p0 - __uint_as_float(hi << 16),
            p1 - __uint_as_float(hi & 0xffff0000u));
}

// two adjacent bf16 in shared memory as one register
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a.b: a 16x16 (row), b 16x8 (col), c 16x8 fp32
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 8i .. 8i+7 give the rows of
// matrix i; with rows as keys (matrices 0, 2: keys 0-7, 1, 3: keys 8-15)
// and columns as head dims (0, 1: d tile dt, 2, 3: dt+1), r[0], r[1] are
// m16n8k16's B operands of P.V over 16 keys at d tile dt, r[2], r[3] at
// dt+1
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

}  // namespace bf16mma
