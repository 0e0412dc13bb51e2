// tf32.cuh: fp32 products on TF32 tensor cores, shared by
// flash_attention.cu (the forward) and flash_attention_bwd.cu (its
// gradient): Veltkamp's split of an fp32 value into exact TF32 parts, the
// mma.sync.m16n8k8 TF32 product, and the cp.async copies that stage tiles
// in shared memory.
//
// TF32 keeps 10 of fp32's 23 mantissa bits.  splitf gives x = hi + lo
// exactly, hi rounded to 11 significant bits (a TF32 value) and lo the
// other 13, of which the tensor cores read the top 10 (they drop the low 13
// bits of a register): hi*hi + hi*lo + lo*hi (3xTF32) is a product off by
// about 2^-22.  split3f splits the rest once more, x = hi + mid + lo
// exactly, three TF32 values (lo holds x's last 2 bits): six terms down to
// mid*mid drop only terms below 2^-33 of the product.
#pragma once

#include <stdint.h>

namespace tf32 {

// x = hi + lo exactly: hi is x rounded to 11 significant bits (a TF32
// value), by Veltkamp's split with 2^13 + 1 in fp32 arithmetic (no
// contraction: each step rounds); lo holds the other 13, of which the
// tensor cores read the top 10 (TF32 drops the low 13 bits of a register)
__device__ __forceinline__ void splitf(float x, float& hi, float& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  hi = __fsub_rn(c, __fsub_rn(c, x));
  lo = __fsub_rn(x, hi);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  splitf(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// c += a.b on the tensor cores: a 16x8 (row), b 8x8 (col), c 16x8 fp32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split2(float2 x, uint32_t& hi0, uint32_t& lo0,
                                       uint32_t& hi1, uint32_t& lo1) {
  split(x.x, hi0, lo0);
  split(x.y, hi1, lo1);
}

// one 16-byte (vec) or 4-byte copy into shared memory; zeros if !valid
template <class T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid,
                                         bool vec) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + mid + lo exactly, three TF32 values (lo holds x's last 2 bits)
__device__ __forceinline__ void split3f(float x, float& hi, float& mid,
                                       float& lo) {
  float r;
  splitf(x, hi, r);
  splitf(r, mid, lo);
}

}  // namespace tf32
