// int8_matmul.cu: int8 (M, K) x int8 (K, N) with exact int32 accumulation,
// then a per-row scale sx (M, 1) and a per-column scale sw (1, N), fp32 out.
//
// Replaces: src/repro/kernels/int8_matmul/kernel.py, int8_matmul_kernel
// (Pallas body _int8_kernel): out = (float(acc) * sx[i]) * sw[j], the two
// products rounded in that order (no reassociation, no FMA).  The JAX
// package reaches it only from its kernel sweep; the port's path is
// serving/quantize.py's int8 weights fed to kernels/int8_matmul/ops.py's
// matmul_int8_dynamic.
//
// Layout: row-major and contiguous, x (M, K), w (K, N), out (M, N); sx and
// sw hold M and N floats.  Any M, N, K >= 1 (no tile alignment: the TPU
// kernel's m % bm == 0 is a TPU tiling limit), K * 127 * 127 < 2^31 so the
// int32 sum cannot overflow (the wrapper checks).
//
// Bound on an H100: at a decode step (M = 4) bytes: the weight is read once,
// K*N bytes against 2*M*K*N operations, 8 operations per byte, far below
// the int8 ridge (1979 TOPS over 3.35 TB/s = 590).  chatglm3-6b's w_in at
// M = 4 reads 56 MB: 16.8 us.  At a prefill (M = 4200) operations:
// 2*M*K*N = 471 G for w_in, 0.24 ms at the tensor cores' dense int8 peak.
//
// Two C entry points, each with its own launch count, run once each per
// product: int8_transpose_kn then int8_mma_f32.  The int8 tensor cores
// (mma.sync.m16n8k32.s8.s8.s32) sum in int32 exactly.  They want both
// operands K-major: the pre-pass writes w's transpose wt (N, Kp), Kp = K
// rounded up to 16 bytes with zeros (w_in: 56 MB read and written once,
// about 0.035 ms at 3.35 TB/s, counted in the product's time), into
// scratch the wrapper allocates.  The product runs one block of 8 warps per
// 128 x 128 output tile, each warp a 64 x 32 sub-tile of 4 x 4 mma tiles
// (64 int32 accumulators a thread).  K advances 64 bytes a stage through a
// 4-stage cp.async ring (16-byte copies, zero-filled past M, N and K), so
// three stages load while one is multiplied; shared rows are padded to 80
// bytes, which makes the ldmatrix fragment loads free of bank conflicts.
// An x whose rows are not 16-byte aligned (K % 16 != 0) is staged with byte
// loads.  The epilogue rounds (float(acc) * sx) * sw with __fmul_rn.
//
// One route for every M: pre-pass included, it beat __dp4a on the CUDA
// cores at every shape the port's paths give the kernel (chatglm3-6b's
// seven projections, M 4 to 4200; PERF.md).  At a decode tick's M most of
// each 128-row tile is zeros, and the weight's bytes, read twice
// (pre-pass and product), set the time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Four consecutive bytes of a row starting at p: element j of the word is
// p[j], masked to `valid` bytes.
__device__ __forceinline__ uint32_t load4(const int8_t* p, int valid,
                                          bool vec) {
  if (valid <= 0) return 0u;
  if (vec && valid >= 4) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t r = 0u;
  for (int j = 0; j < 4 && j < valid; ++j)
    r |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return r;
}

constexpr int TM = 128, TN = 128, TK = 64;  // output tile; K bytes a stage
constexpr int kStages = 4;
constexpr int kRowB = TK + 16;  // shared row stride in bytes
constexpr int kStageB = (TM + TN) * kRowB;
constexpr int kMmaSmem = kStages * kStageB;  // 81,920 bytes

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w (K, N) -> wt (N, Kp), zeros at k >= K; one block per 64 x 64 bytes
__global__ void __launch_bounds__(kThreads)
int8_transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                      int K, int N, int Kp, bool vec) {
  __shared__ uint8_t t_s[64][64 + 4];
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e >> 4, nw = e & 15;
    const int k = k0 + row, n = n0 + 4 * nw;
    *reinterpret_cast<uint32_t*>(&t_s[row][4 * nw]) =
        k < K ? load4(w + (size_t)k * N + n, N - n, vec) : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int nr = e >> 4, kw = e & 15;
    const int n = n0 + nr, k = k0 + 4 * kw;
    if (n < N && k < Kp)
      *reinterpret_cast<uint32_t*>(wt + (size_t)n * Kp + k) =
          (uint32_t)t_s[4 * kw][nr] | (uint32_t)t_s[4 * kw + 1][nr] << 8 |
          (uint32_t)t_s[4 * kw + 2][nr] << 16 |
          (uint32_t)t_s[4 * kw + 3][nr] << 24;
  }
}

// K bytes k0 .. k0+TK-1 of the tile's 128 rows of x and of wt into a stage
template <bool VEC_X>
__device__ __forceinline__ void load_stage(uint8_t* st,
                                           const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ wt,
                                           int M, int N, int K, int Kp,
                                           int m0, int n0, int k0) {
  uint8_t* a_s = st;
  uint8_t* b_s = st + TM * kRowB;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = threadIdx.x + i * kThreads;  // row e/4, 16-byte chunk e%4
    const int r = e >> 2, c = (e & 3) * 16;
    const int m = m0 + r, k = k0 + c;
    if (VEC_X) {
      const bool ok = m < M && k < K;
      cp16(a_s + r * kRowB + c, ok ? x + (size_t)m * K + k : x, ok);
    } else {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if (m < M)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (k + j < K)
            wd[j >> 2] |= (uint32_t)(uint8_t)x[(size_t)m * K + k + j]
                          << (8 * (j & 3));
      *reinterpret_cast<uint4*>(a_s + r * kRowB + c) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    const int n = n0 + r;
    const bool ok = n < N && k < Kp;
    cp16(b_s + r * kRowB + c, ok ? wt + (size_t)n * Kp + k : wt, ok);
  }
}

template <bool VEC_X>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ out, int M, int N, int K, int Kp) {
  extern __shared__ __align__(16) uint8_t smem8[];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int KT = (Kp + TK - 1) / TK;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      load_stage<VEC_X>(smem8 + s * kStageB, x, wt, M, N, K, Kp, m0, n0,
                        s * TK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // ldmatrix lanes: A's four 8x8 matrices are (rows 0-7 | 8-15) x (k 0-15 |
  // 16-31) in that order, B's (k 0-15 | 16-31) x (n 0-7 | 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();  // stage kt has landed; stage kt-1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < KT)
      load_stage<VEC_X>(smem8 + (nxt % kStages) * kStageB, x, wt, M, N, K, Kp,
                        m0, n0, nxt * TK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint8_t* a_s = smem8 + (kt % kStages) * kStageB;
    const uint8_t* b_s = a_s + TM * kRowB;
#pragma unroll
    for (int ks = 0; ks < TK / 32; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], a_s + (wm * 64 + mi * 16 + a_row) * kRowB + ks * 32 +
                            a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bf[nj], b_s + (wn * 32 + nj * 16 + b_row) * kRowB + ks * 32 +
                            b_col);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                 bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // acc[mi][ni][e]: row gq + 8*(e>>1), column 2*tq + (e&1) of mma tile
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int m = m0 + wm * 64 + mi * 16 + gq + 8 * e2;
      if (m >= M) continue;
      const float s_row = sx[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq + e1;
          if (n < N)
            out[(size_t)m * N + n] = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * e2 + e1]), s_row),
                sw[n]);
        }
    }
}

template <bool VEC_X>
int launch_mma(const int8_t* x, const int8_t* wt, const float* sx,
               const float* sw, float* out, int M, int N, int K, int Kp,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_mma_kernel<VEC_X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  int8_mma_kernel<VEC_X><<<grid, kThreads, kMmaSmem, stream>>>(
      x, wt, sx, sw, out, M, N, K, Kp);
  return (int)cudaGetLastError();
}

}  // namespace

// The pre-pass: w (K, N) int8 contiguous -> wt (N, Kp)
// int8, Kp a multiple of 16 and at least K, zeros at k >= K.
extern "C" int int8_transpose_kn(const void* w, void* wt, int K, int N, int Kp,
                                 void* stream) {
  if (K <= 0 || N <= 0 || Kp < K || Kp % 16 || (Kp + 63) / 64 > 65535 ||
      ((uintptr_t)wt & 15u))
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && ((uintptr_t)w & 3u) == 0;
  const dim3 grid((N + 63) / 64, (Kp + 63) / 64);
  int8_transpose_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, (int8_t*)wt, K, N, Kp, vec);
  return (int)cudaGetLastError();
}

// The product.  x (M, K) int8 contiguous, wt (N, Kp) from
// int8_transpose_kn, sx (M) f32, sw (N) f32, out (M, N) f32.
extern "C" int int8_mma_f32(const void* x, const void* wt, const void* sx,
                            const void* sw, void* out, int M, int N, int K,
                            int Kp, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % 16 ||
      (M + TM - 1) / TM > 65535 || ((uintptr_t)wt & 15u))
    return (int)cudaErrorInvalidValue;
  const bool vec_x = K % 16 == 0 && ((uintptr_t)x & 15u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xi = (const int8_t*)x;
  const int8_t* wi = (const int8_t*)wt;
  const float* sxf = (const float*)sx;
  const float* swf = (const float*)sw;
  float* of = (float*)out;
  return vec_x ? launch_mma<true>(xi, wi, sxf, swf, of, M, N, K, Kp, st)
               : launch_mma<false>(xi, wi, sxf, swf, of, M, N, K, Kp, st);
}
