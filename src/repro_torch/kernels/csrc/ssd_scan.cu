// ssd_scan.cu: the within-chunk terms of Mamba2's chunked SSD, fp32.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_scan_kernel (Pallas
// body _ssd_kernel).  The JAX model computes the same terms in plain jnp
// (models/ssm.py, _ssd_chunked); the port's Mamba2 prefill calls this
// through kernels/ssd_scan/ops.py::ssd, which keeps the cumsum, the
// inter-chunk recurrence and the cross-chunk term in PyTorch.
//
// Per (chunk bc, head h), with group g = h / (H / G):
//   y_diag[i, p]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, p]
//   s_local[n, p] = sum_j B[j, n] exp(cs_{Q-1} - cs_j) dt_j x[j, p]
// Layout (the reference kernel's): x (BC, H, Q, P), B/C (BC, G, Q, N),
// cs/dt (BC, H, 1, Q); y_diag (BC, H, Q, P), s_local (BC, H, N, P).
//
// Bound on an H100: operations.  C . B over the causal pairs costs 2 N per
// pair once per group; each head then needs 2 P per pair and 2 N P per
// key.  At Mamba2-130m's 512-token prefill (2 chunks of Q = 256, N = 128,
// P = 64, 24 heads in one group) that is 0.42 GFLOP against 8.4 MB moved,
// about 50 operations per byte, above the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20): 6.3 us.  A short prompt's single chunk (Q = 13) is a
// few hundred KB and bound by bytes.
//
// Design: one launch writes both outputs.  A block owns one (chunk, head)
// and a job: a pair of 32-row tiles of y_diag, i and nt-1-i, so that every
// pair walks nt+1 key tiles of the causal triangle (the middle tile of an
// odd nt alone), or one 32-row tile of s_local's N rows (nt key tiles).
// Both are out[r, :] = sum_j coef[r, j] x[j, :] over 32-key tiles: for
// y_diag, coef = (C_r . B_j) exp(cs_r - cs_j) dt_j masked to j <= r, with
// C . B^T formed in the block from C's 32 rows (staged once per row tile)
// and the key tile's B rows, recomputed per head as the reference kernel
// does (the group's heads are other blocks); for s_local, coef = B[j, n]
// exp(cs_last - cs_j) dt_j.  Key tiles of B, x, cs and dt stream through
// a ring of two shared-memory stages by cp.async (16-byte copies where
// the rows allow), tile t+1 loading while tile t is computed; a key tile
// costs two __syncthreads.  Both products run on the tensor cores, TF32
// mma.sync.m16n8k8 on operands split as their fragments are read
// (Veltkamp's split, flash_attention.cu's arithmetic): C.B^T in 3xTF32
// (hi*hi + hi*lo + lo*hi), each of the 8 warps on 16 rows and 8 keys over
// the state dims; the coefficients go through shared memory; the output
// product in six terms on three-part coefficients and x (as
// flash_attention.cu's P.V), each warp on 16 rows and 16 (P <= 64) or 32
// columns; s_local's coefficients B w are formed in float64 (w once a key
// tile, one more __syncthreads) and kept as two floats (the rest a seventh
// term on x's hi), so that it rounds nothing before the sum where the
// plain version rounds exp, w and w x in fp32.  hi*hi is summed in a fresh accumulator, two k-steps at a time
// in C.B^T and a key tile at a time in the output, and added with fp32
// adds: the tensor cores' own long sums drifted 12-50x farther from the
// plain version than the CUDA cores' fp32 sums.  Against float64
// (tests/test_torch_flash_split.py emulates the scheme, chip_smoke.py
// measures the kernel) 3xTF32 in the output put s_local 2.3-3.9x as far
// as fp32's sums, the six terms on fp32 coefficients up to 1.85x, the
// float64 coefficients below it; y_diag's C.B^T rounds less in 3xTF32
// than fp32 does.  Keeping the operands unsplit in shared memory
// fits three blocks an SM at mamba2-130m's shape, where C and the
// coefficients kept split fit two.
// Any Q up to 256: rows and keys past Q are zero-filled and masked, so an
// exact-length prefill of 13 tokens is one chunk of Q = 13.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;               // rows of an output tile, keys a tile
constexpr int kLC = kT + 8;          // coef row stride (64-bit fragments)
constexpr int kStages = 2;           // key tiles in the ring: 1 in flight

// x = hi + lo exactly: hi is x rounded to 11 significant bits (a TF32
// value), by Veltkamp's split in fp32 arithmetic (flash_attention.cu's)
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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + mid + lo exactly, three TF32 values (lo holds x's last 2 bits)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  float h, r, m, l;
  splitf(x, h, r);
  splitf(r, m, l);
  hi = __float_as_uint(h);
  mid = __float_as_uint(m);
  lo = __float_as_uint(l);
}

// the A fragment of rows r, r+8 at k-columns k0 + 2tq, k0 + 2tq + 1 (k-index
// t of an 8-wide step stands for column 2t, t+4 for 2t+1) from an array of
// row stride ld
__device__ __forceinline__ void load_a(float (&f)[4], const float* a, int ld) {
  const float2 a0 = *reinterpret_cast<const float2*>(a);
  const float2 a1 = *reinterpret_cast<const float2*>(a + 8 * ld);
  f[0] = a0.x;
  f[1] = a1.x;
  f[2] = a0.y;
  f[3] = a1.y;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, bool vec) {
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

// rows row0 .. row0+31 (< rmax) and columns col0 .. col0+width-1 (< cmax)
// of a row-major source into dst (row stride ld); zeros elsewhere
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int stride, int row0, int rmax,
                                          int col0, int cmax, int width,
                                          bool vec) {
  const int w = vec ? 4 : 1, per = width / w;
  for (int e = threadIdx.x; e < kT * per; e += kThreads) {
    const int r = e / per, c = (e % per) * w;
    const bool ok = row0 + r < rmax && col0 + c < cmax;
    cp_async(dst + r * ld + c,
             ok ? src + (size_t)(row0 + r) * stride + col0 + c : src, ok,
             vec);
  }
}

// the shared-memory layout, in floats, for N state dims and PT 64-column
// groups of x: C's rows, the coefficient tile, the cs of a y tile's rows,
// then kStages x (B's key rows, x's key rows, cs, dt), then a key tile's
// w as doubles: 74 KB at mamba2-130m's N 128 and P 64, three blocks an SM
struct Layout {
  int LN, LX, NK;
  __host__ __device__ Layout(int N, int PT)
      : LN((N + 31) / 32 * 32 + 8), LX(64 * PT + 4), NK((N + 7) / 8 * 8) {}
  __host__ __device__ int stage() const { return kT * (LN + LX) + 2 * kT; }
  __host__ __device__ int total() const {
    return kT * LN + kT * kLC + kT + kStages * stage() + 2 * kT;
  }
};

// PT 64-column groups of the output (P <= 64 PT)
template <int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ cs,
                const float* __restrict__ dt, float* __restrict__ y,
                float* __restrict__ s_out, int H, int G, int Q, int P, int N,
                bool vec) {
  constexpr int NT = 2 * PT;           // the warp's 8-column tiles of out
  const Layout L(N, PT);
  const int LN = L.LN, LX = L.LX, NK = L.NK, SS = L.stage();
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;                   // [kT][LN]: C's rows of a y tile
  float* k_s = c_s + kT * LN;          // [kT][kLC]: the coefficients
  float* csr_s = k_s + kT * kLC;       // [kT]: cs of a y tile's rows
  float* st_s = csr_s + kT;            // the stages
  // s_local: w of a key tile's keys (after the stages; 8-byte aligned)
  double* w_s = reinterpret_cast<double*>(st_s + kStages * SS);

  const int h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  const int nt = (Q + kT - 1) / kT, npairs = (nt + 1) / 2;
  const int job = blockIdx.x;
  const bool is_y = job < npairs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column group
  const int wm = warp >> 2;                 // the warp's 16 rows of a tile
  const int wn = warp & 3;                  // its 8 keys of C.B, and its
                                            // NT 8-column tiles of out
  const float* xh = x + ((size_t)bc * H + h) * Q * P;
  const float* bg = bm + ((size_t)bc * G + g) * Q * N;
  const float* cg = cm + ((size_t)bc * G + g) * Q * N;
  const float* csh = cs + ((size_t)bc * H + h) * Q;
  const float* dth = dt + ((size_t)bc * H + h) * Q;
  const float cs_last = csh[Q - 1];
  const int n0 = is_y ? 0 : (job - npairs) * kT;

  const int n_tiles = is_y && job != nt - 1 - job ? 2 : 1;
  for (int rt = 0; rt < n_tiles; ++rt) {
    const int it = is_y ? (rt == 0 ? job : nt - 1 - job) : 0;
    const int r0 = is_y ? it * kT : n0;
    const int n_keys = is_y ? it + 1 : nt;    // key tiles this tile needs

    __syncthreads();                   // the previous tile's buffers are free
    if (is_y) {
      load_rows(c_s, LN, cg, N, r0, Q, 0, N, NK, vec);
      if (tid < kT) csr_s[tid] = r0 + tid < Q ? csh[r0 + tid] : 0.0f;
    }
    auto load_keys = [&](int jt) {
      const int j0 = jt * kT;
      float* bs = st_s + (jt % kStages) * SS;
      float* xs = bs + kT * LN;
      if (is_y)
        load_rows(bs, LN, bg, N, j0, Q, 0, N, NK, vec);
      else
        load_rows(bs, LN, bg, N, j0, Q, n0, N, kT, vec);
      load_rows(xs, LX, xh, P, j0, Q, 0, P, 64 * PT, vec);
      if (tid < kT) {
        const bool ok = j0 + tid < Q;
        cp_async(xs + kT * LX + tid, ok ? csh + j0 + tid : csh, ok, false);
        cp_async(xs + kT * LX + kT + tid, ok ? dth + j0 + tid : dth, ok,
                 false);
      }
    };
#pragma unroll
    for (int jt = 0; jt < kStages - 1; ++jt) {   // one group each, even empty
      if (jt < n_keys) load_keys(jt);
      cp_commit();
    }

    // the output's fragments: rows wm*16 + gq (+8), columns (wn*NT + n)*8
    // + 2tq (+1)
    float acc[NT][4], accx[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = accx[n][e] = 0.0f;

    for (int jt = 0; jt < n_keys; ++jt) {
      const int j0 = jt * kT;
      cp_wait<kStages - 2>();          // key tile jt (and C) have landed
      __syncthreads();                 // and tile jt-1 is consumed
      if (jt + kStages - 1 < n_keys) load_keys(jt + kStages - 1);
      cp_commit();
      const float* bs = st_s + (jt % kStages) * SS;
      const float* xs = bs + kT * LN;
      const float* css = xs + kT * LX;
      const float* dts = css + kT;
      if (is_y) {
        // C.B^T, rows wm*16.., keys wn*8..: 3xTF32 over the state dims,
        // C and B split as they are read; hi*hi in a fresh accumulator per
        // two k-steps, added to cb with fp32 adds
        float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float cbx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int aoff = (wm * 16 + gq) * LN + 2 * tq;
        const float* br = bs + (wn * 8 + gq) * LN + 2 * tq;
        for (int k0 = 0; k0 < NK; k0 += 16) {
          float tt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = k0 + 8 * h;
            if (kk >= NK) break;
            float af[4];
            uint32_t ahi[4], alo[4];
            load_a(af, c_s + aoff + kk, LN);
#pragma unroll
            for (int e = 0; e < 4; ++e) split(af[e], ahi[e], alo[e]);
            const float2 b2 = *reinterpret_cast<const float2*>(br + kk);
            uint32_t bh0, bl0, bh1, bl1;
            split(b2.x, bh0, bl0);
            split(b2.y, bh1, bl1);
            mma(cbx, alo, bh0, bh1);
            mma(cbx, ahi, bl0, bl1);
            mma(tt, ahi, bh0, bh1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[e] += tt[e];
        }
        // coef[r, j] = (C_r . B_j) exp(cs_r - cs_j) dt_j for j <= r < Q
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 16 + gq + 8 * (e >> 1);
          const int j = wn * 8 + 2 * tq + (e & 1);
          const int rr = r0 + r, jj = j0 + j;
          const float c = rr < Q && jj <= rr
              ? (cb[e] + cbx[e]) * expf(csr_s[r] - css[j]) * dts[j]
              : 0.0f;
          k_s[r * kLC + j] = c;
        }
      } else {
        // coef[n, j] = B[j, n0 + n] w_j, w_j = exp(cs_last - cs_j) dt_j,
        // in float64 (w once a key), kept as two floats: the rounded
        // coefficient in k_s, its rest in c_s, which an s_local block does
        // not use; lanes run along n
        if (tid < kT)
          w_s[tid] = j0 + tid < Q ? exp((double)cs_last - (double)css[tid]) *
                                        (double)dts[tid]
                                  : 0.0;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = tid % kT, j = tid / kT + 8 * u;
          const double c = j0 + j < Q && n0 + n < N
              ? (double)bs[j * LN + n] * w_s[j] : 0.0;
          const float ch = (float)c;
          k_s[n * kLC + j] = ch;
          c_s[n * kLC + j] = (float)(c - (double)ch);
        }
      }
      __syncthreads();
      // out += coef . x over the tile's keys: six terms on three-part
      // coefficients and x, split as they are read (B fragment: k-index t
      // is key 2t, t+4 is key 2t+1), and for s_local the coefficients'
      // rest times x's hi; hi*hi in a fresh accumulator per tile, added to
      // acc with fp32 adds
      const int aoff = (wm * 16 + gq) * kLC + 2 * tq;
      float tb[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tb[n][e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < kT; k0 += 8) {
        float af[4];
        uint32_t ahi[4], ami[4], alo[4];
        load_a(af, k_s + aoff + k0, kLC);
#pragma unroll
        for (int e = 0; e < 4; ++e) split3(af[e], ahi[e], ami[e], alo[e]);
        uint32_t arest[4] = {0u, 0u, 0u, 0u};
        if (!is_y) {
          load_a(af, c_s + aoff + k0, kLC);
#pragma unroll
          for (int e = 0; e < 4; ++e) arest[e] = __float_as_uint(af[e]);
        }
        const float* xr = xs + (k0 + 2 * tq) * LX + gq;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c0 = (wn * NT + n) * 8;
          uint32_t bh0, bm0, bl0, bh1, bm1, bl1;
          split3(xr[c0], bh0, bm0, bl0);
          split3(xr[c0 + LX], bh1, bm1, bl1);
          mma(accx[n], alo, bh0, bh1);
          mma(accx[n], ahi, bl0, bl1);
          mma(accx[n], ami, bm0, bm1);
          mma(accx[n], ami, bh0, bh1);
          mma(accx[n], ahi, bm0, bm1);
          if (!is_y) mma(accx[n], arest, bh0, bh1);
          mma(tb[n], ahi, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += tb[n][e];
    }
    cp_wait<0>();

    const int R = is_y ? Q : N;        // rows of this output
    float* out = is_y ? y + ((size_t)bc * H + h) * Q * P
                      : s_out + ((size_t)bc * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + wm * 16 + gq + 8 * i;
      if (r >= R) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int p = (wn * NT + n) * 8 + 2 * tq;
        float* op = out + (size_t)r * P + p;
        const float v0 = acc[n][2 * i] + accx[n][2 * i];
        const float v1 = acc[n][2 * i + 1] + accx[n][2 * i + 1];
        if (vec && p + 2 <= P) {
          *reinterpret_cast<float2*>(op) = make_float2(v0, v1);
        } else {
          if (p < P) op[0] = v0;
          if (p + 1 < P) op[1] = v1;
        }
      }
    }
  }
}

template <int PT>
int launch(const float* x, const float* bm, const float* cm, const float* cs,
           const float* dt, float* y, float* s_local, int BC, int H, int G,
           int Q, int P, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout(N, PT).total();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies and 8-byte stores where every row allows
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
      ((((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm | (uintptr_t)y |
         (uintptr_t)s_local) & 15u) == 0);
  const int nt = (Q + kT - 1) / kT;
  const dim3 grid((nt + 1) / 2 + (N + kT - 1) / kT, H, BC);
  ssd_scan_kernel<PT><<<grid, kThreads, smem, stream>>>(
      x, bm, cm, cs, dt, y, s_local, H, G, Q, P, N, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (BC, H, Q, P), B/C (BC, G, Q, N), cs/dt (BC, H, 1, Q) float32
// contiguous -> y_diag (BC, H, Q, P), s_local (BC, H, N, P).  One launch
// on `stream`.
extern "C" int ssd_scan_f32(const void* x, const void* bm, const void* cm,
                            const void* cs, const void* dt, void* y,
                            void* s_local, int BC, int H, int G, int Q, int P,
                            int N, void* stream) {
  if (BC <= 0 || H <= 0 || G <= 0 || H % G || Q <= 0 || Q > 256 || P <= 0 ||
      P > 128 || N <= 0 || N > 256 || BC > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* bf = (const float*)bm;
  const float* cf = (const float*)cm;
  const float* csf = (const float*)cs;
  const float* dtf = (const float*)dt;
  cudaStream_t st = (cudaStream_t)stream;
  if (P <= 64)
    return launch<1>(xf, bf, cf, csf, dtf, (float*)y, (float*)s_local, BC, H,
                     G, Q, P, N, st);
  return launch<2>(xf, bf, cf, csf, dtf, (float*)y, (float*)s_local, BC, H, G,
                   Q, P, N, st);
}
