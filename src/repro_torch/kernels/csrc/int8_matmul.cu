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
// Design (simple and right first; wgmma, TMA and a pre-packed weight
// layout are later work): one block of 256 threads per 64 x 64 output tile
// walks K in panels of 64.  Each panel is staged in shared memory packed
// four k at a time into one 32-bit word, for a row of x and for a column
// of w (w's 4 x 4 byte blocks are transposed with __byte_perm on the way),
// so the inner loop is __dp4a: four int8 products added to an int32 in one
// instruction.  Each thread owns 4 x 4 outputs (rows ty + 16i, columns
// tx + 16j).  The next panel's global loads are issued before the current
// panel's arithmetic, into registers.  Ragged edges are masked in the
// loads (zeros past M, N or K add nothing) and in the stores; 32-bit loads
// are used where the rows are 4-byte aligned, single bytes elsewhere.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;   // output tile, K panel (bytes)
constexpr int KW = BK / 4;                 // packed words per panel row
constexpr int PAD = 4;                     // shared row padding (words)
constexpr int kThreads = 256;
constexpr int kAWords = BM * KW / kThreads;  // x words per thread (4)

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

struct Panel {
  uint32_t a[kAWords];  // packed x words
  uint32_t b[4];        // packed w words: columns 4*nq + j, k 4*kw..+3
};

__device__ __forceinline__ void load_panel(
    Panel& pn, const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    int M, int N, int K, int m0, int n0, int k0, bool vec_x, bool vec_w) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kAWords; ++r) {
    const int e = tid + r * kThreads;
    const int row = e / KW, kw = e % KW;
    const int m = m0 + row, k = k0 + 4 * kw;
    pn.a[r] = m < M ? load4(x + (size_t)m * K + k, K - k, vec_x) : 0u;
  }
  // one 4 (k) x 4 (n) byte block per thread, transposed to 4 words
  const int kw = tid / (BN / 4), nq = tid % (BN / 4);
  const int n = n0 + 4 * nq;
  uint32_t rows[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int k = k0 + 4 * kw + t;
    rows[t] = k < K ? load4(w + (size_t)k * N + n, N - n, vec_w) : 0u;
  }
  const uint32_t lo01 = __byte_perm(rows[0], rows[1], 0x5140);
  const uint32_t hi01 = __byte_perm(rows[0], rows[1], 0x7362);
  const uint32_t lo23 = __byte_perm(rows[2], rows[3], 0x5140);
  const uint32_t hi23 = __byte_perm(rows[2], rows[3], 0x7362);
  pn.b[0] = __byte_perm(lo01, lo23, 0x5410);
  pn.b[1] = __byte_perm(lo01, lo23, 0x7632);
  pn.b[2] = __byte_perm(hi01, hi23, 0x5410);
  pn.b[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void store_panel(const Panel& pn,
                                            uint32_t (*a_s)[BM + PAD],
                                            uint32_t (*b_s)[BN + PAD]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kAWords; ++r) {
    const int e = tid + r * kThreads;
    a_s[e % KW][e / KW] = pn.a[r];
  }
  const int kw = tid / (BN / 4), nq = tid % (BN / 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) b_s[kw][4 * nq + j] = pn.b[j];
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx,
                   const float* __restrict__ sw, float* __restrict__ out,
                   int M, int N, int K, bool vec_x, bool vec_w) {
  __shared__ uint32_t a_s[KW][BM + PAD];
  __shared__ uint32_t b_s[KW][BN + PAD];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  Panel pn;
  load_panel(pn, x, w, M, N, K, m0, n0, 0, vec_x, vec_w);
  store_panel(pn, a_s, b_s);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_panel(pn, x, w, M, N, K, m0, n0, k0 + BK, vec_x, vec_w);
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = (int)a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = (int)b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store_panel(pn, a_s, b_s);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s_row = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        out[(size_t)m * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s_row), sw[n]);
    }
  }
}

}  // namespace

// x (M, K) int8, w (K, N) int8, sx (M) f32, sw (N) f32, out (M, N) f32, all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int int8_matmul_f32(const void* x, const void* w, const void* sx,
                               const void* sw, void* out, int M, int N, int K,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec_x = K % 4 == 0 && ((uintptr_t)x & 3u) == 0;
  const bool vec_w = N % 4 == 0 && ((uintptr_t)w & 3u) == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)sx, (const float*)sw,
      (float*)out, M, N, K, vec_x, vec_w);
  return (int)cudaGetLastError();
}
