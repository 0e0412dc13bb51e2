// bf16.cuh: bf16 tensor-core products with fp32 accumulators, shared by
// flash_attention.cu (flash_attention_bf16) and decode_attention.cu
// (decode_attention_bf16): the mma.sync m16n8k16 and m16n8k8 bf16
// products, ldmatrix's transposed loads (a row-major V tile as the B
// operand of P.V), and the packing of two fp32 values into a bf16x2
// register.
//
// The product of two bf16 values is exact in fp32 (8 + 8 significant bits),
// so a bf16 mma differs from an fp32 dot of the same values only in how it
// sums.  An fp32 value p packs as its bf16 rounding hi and the bf16 rounding
// of the rest, lo = bf16(p - hi): hi + lo keeps about 16 of p's bits, so
// P.V as hi.V + lo.V (V exact in bf16) stays within ~2^-17 of fp32's P.V.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "...m16n8k8", .bf16): lane = 4 * g + t.  A (16 x 16, row): register 0
// holds A[g][2t, 2t+1], 1 A[g+8][2t, 2t+1], 2 A[g][2t+8, 2t+9], 3
// A[g+8][2t+8, 2t+9] (the lower column in the low half).  B (16 x 8, col):
// register 0 holds B[2t, 2t+1][g], 1 B[2t+8, 2t+9][g].  C (16 x 8, fp32):
// c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].  m16n8k8 takes A's
// registers 0 and 1 and B's register 0.  So an accumulator tile of S
// (16 rows x 8 keys) is, packed pairwise, the A operand of P.V over those
// 8 keys (k8), and two adjacent tiles the A operand over 16 keys (k16):
// no shuffle.
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
// (lo), each pair packed
__device__ __forceinline__ void pack_split(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  __nv_bfloat162 h, l;
  h.x = h0;
  h.y = h1;
  l.x = __float2bfloat16_rn(p0 - __bfloat162float(h0));
  l.y = __float2bfloat16_rn(p1 - __bfloat162float(h1));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
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

// c += a.b: a 16x8 (row; registers 0 and 1 of the layout above), b 8x8
// (col), c 16x8 fp32
__device__ __forceinline__ void mma8(float (&c)[4], uint32_t a0, uint32_t a1,
                                     uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// four 8x8 bf16 matrices from shared memory, transposed: lanes 8i .. 8i+7
// give the 16-byte rows of matrix i, and r[i] holds rows 2t and 2t+1 of
// its column g: with rows as keys and columns as head dims, B operands of
// P.V from a row-major V tile
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// two such matrices (lanes 0-15 give the rows)
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

}  // namespace bf16mma
