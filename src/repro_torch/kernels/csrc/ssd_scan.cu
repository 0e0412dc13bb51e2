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
// 3.35 TB/s = 20): 6.3 us.
//
// Design: two launches, two entry points.  The first computes CB = C . B^T once per (chunk,
// group) for the key tiles at or below the diagonal, into a scratch
// (BC, G, Q, Q) the wrapper allocates: all H/G heads of a group share it
// (the reference's kernel recomputes it per head).  The second writes
// both outputs as out[r, p] = sum_j coef[r, j] x[j, p], with coef built
// per 32 x 32 tile in shared memory: CB[r, j] exp(cs_r - cs_j) dt_j masked
// to j <= r for y_diag (the masked decay L is never materialised), and
// B[j, r] exp(cs_last - cs_j) dt_j for s_local.  A block owns 32 output
// rows of one (chunk, head), of y_diag or of s_local (grid.x = ceil(Q/32)
// + ceil(N/32)), walks the keys in tiles of 32 (a y_diag block stops at
// the diagonal tile) and keeps its 32 x P outputs in registers.  Any Q up
// to 256: rows and keys past Q are masked, so an exact-length prefill of
// 13 tokens is one chunk of Q = 13.  fp32 on CUDA cores keeps the
// reference sweep's 1e-4 tolerance.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;               // rows and keys per tile
constexpr int kNC = 64;              // state dims staged per step of C . B
constexpr int kMaxP = 128;
constexpr int kMaxAcc = kT * kMaxP / kThreads;

// CB[bc, g, i, j] = C[bc, g, i] . B[bc, g, j] for the 32 x 32 tile
// (blockIdx.x, blockIdx.y) = (i tile, j tile), j tile <= i tile.
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, int Q, int N) {
  const int it = blockIdx.x, jt = blockIdx.y, bg = blockIdx.z;
  if (jt > it) return;               // above the diagonal: never read
  __shared__ float c_s[kT][kNC + 1];
  __shared__ float b_s[kT][kNC + 1];
  const float* cg = cm + (size_t)bg * Q * N;
  const float* bgp = bm + (size_t)bg * Q * N;
  const int i0 = it * kT, j0 = jt * kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dot[kT / 8] = {};
  for (int n0 = 0; n0 < N; n0 += kNC) {
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kNC; e += kThreads) {
      const int r = e / kNC, n = e % kNC;
      const bool nn = n0 + n < N;
      c_s[r][n] = nn && i0 + r < Q ? cg[(size_t)(i0 + r) * N + n0 + n] : 0.f;
      b_s[r][n] = nn && j0 + r < Q ? bgp[(size_t)(j0 + r) * N + n0 + n] : 0.f;
    }
    __syncthreads();
    // lane = key j, each warp 4 rows
#pragma unroll
    for (int u = 0; u < kT / 8; ++u) {
      const int r = warp * (kT / 8) + u;
      float a = dot[u];
#pragma unroll 16
      for (int n = 0; n < kNC; ++n) a = fmaf(c_s[r][n], b_s[lane][n], a);
      dot[u] = a;
    }
  }
  const int j = j0 + lane;
#pragma unroll
  for (int u = 0; u < kT / 8; ++u) {
    const int i = i0 + warp * (kT / 8) + u;
    if (i < Q && j < Q) cb[((size_t)bg * Q + i) * Q + j] = dot[u];
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                const float* __restrict__ cb, const float* __restrict__ cs,
                const float* __restrict__ dt, float* __restrict__ y,
                float* __restrict__ s_out, int H, int G, int Q, int P, int N) {
  extern __shared__ float smem[];
  float* x_s = smem;                     // [kT][P]
  float* coef_s = x_s + kT * P;          // [kT][kT + 1]
  float* csj_s = coef_s + kT * (kT + 1); // [kT]
  float* dtj_s = csj_s + kT;             // [kT]

  const int h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  const int n_ytiles = (Q + kT - 1) / kT;
  const bool is_y = (int)blockIdx.x < n_ytiles;
  const int r0 = (is_y ? blockIdx.x : blockIdx.x - n_ytiles) * kT;
  const int R = is_y ? Q : N;            // rows of this output
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xh = x + ((size_t)bc * H + h) * Q * P;
  const float* bg = bm + ((size_t)bc * G + g) * Q * N;
  const float* cbg = cb + ((size_t)bc * G + g) * Q * Q;
  const float* csh = cs + ((size_t)bc * H + h) * Q;
  const float* dth = dt + ((size_t)bc * H + h) * Q;
  const float cs_last = csh[Q - 1];

  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.0f;

  // a y_diag block needs keys j <= its last row; s_local needs all
  const int j_end = is_y ? min(Q, r0 + kT) : Q;
  for (int j0 = 0; j0 < j_end; j0 += kT) {
    __syncthreads();                     // the previous tile is consumed
    for (int e = tid; e < kT * P; e += kThreads) {
      const int j = e / P, p = e % P;
      x_s[j * P + p] = j0 + j < Q ? xh[(size_t)(j0 + j) * P + p] : 0.0f;
    }
    if (tid < kT) {
      csj_s[tid] = j0 + tid < Q ? csh[j0 + tid] : 0.0f;
      dtj_s[tid] = j0 + tid < Q ? dth[j0 + tid] : 0.0f;
    }
    __syncthreads();

    // coefficient tile, 4 entries a thread; lanes run along the row of CB
    // (y_diag) or of B (s_local) so that the loads coalesce
#pragma unroll
    for (int u = 0; u < kT / 8; ++u) {
      const int a = warp * (kT / 8) + u;
      const int r = is_y ? a : lane, j = is_y ? lane : a;
      const int rr = r0 + r, jj = j0 + j;
      float c = 0.0f;
      if (is_y) {
        if (rr < Q && jj <= rr)          // jj <= rr < Q: a real key
          c = cbg[(size_t)rr * Q + jj] * expf(csh[rr] - csj_s[j]) * dtj_s[j];
      } else if (rr < N && jj < Q) {
        c = bg[(size_t)jj * N + rr] * (expf(cs_last - csj_s[j]) * dtj_s[j]);
      }
      coef_s[r * (kT + 1) + j] = c;
    }
    __syncthreads();

    const int jn = min(kT, Q - j0);
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int e = tid + kThreads * k;
      if (e < kT * P) {
        const int r = e / P, p = e % P;
        const float* cr = coef_s + r * (kT + 1);
        float a = acc[k];
        for (int t = 0; t < jn; ++t) a = fmaf(cr[t], x_s[t * P + p], a);
        acc[k] = a;
      }
    }
  }

  float* out = is_y ? y + ((size_t)bc * H + h) * Q * P
                    : s_out + ((size_t)bc * H + h) * N * P;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int e = tid + kThreads * k;
    if (e < kT * P) {
      const int r = e / P, p = e % P;
      if (r0 + r < R) out[(size_t)(r0 + r) * P + p] = acc[k];
    }
  }
}

}  // namespace

// x (BC, H, Q, P), B/C (BC, G, Q, N), cs/dt (BC, H, 1, Q) float32
// contiguous; cb a (BC, G, Q, Q) float32 scratch -> y_diag (BC, H, Q, P),
// s_local (BC, H, N, P).  Two launches on `stream`.
// The two launches are two entry points, so that each is counted where it
// is launched: ssd_cb_f32 fills the scratch CB, then ssd_scan_f32 reads it.
extern "C" int ssd_cb_f32(const void* bm, const void* cm, void* cb, int BC,
                          int G, int Q, int N, void* stream) {
  if (BC <= 0 || G <= 0 || Q <= 0 || Q > 256 || N <= 0 || N > 256 ||
      BC * G > 65535)
    return (int)cudaErrorInvalidValue;
  const int nt = (Q + kT - 1) / kT;
  ssd_cb_kernel<<<dim3(nt, nt, BC * G), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)bm, (const float*)cm, (float*)cb, Q, N);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scan_f32(const void* x, const void* bm, const void* cb,
                            const void* cs, const void* dt, void* y,
                            void* s_local, int BC, int H, int G, int Q, int P,
                            int N, void* stream) {
  if (BC <= 0 || H <= 0 || G <= 0 || H % G || Q <= 0 || Q > 256 || P <= 0 ||
      P > kMaxP || N <= 0 || N > 256 || BC > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int nt = (Q + kT - 1) / kT;
  const size_t smem = sizeof(float) * (kT * P + kT * (kT + 1) + 2 * kT);
  const dim3 grid(nt + (N + kT - 1) / kT, H, BC);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bm, (const float*)cb, (const float*)cs,
      (const float*)dt, (float*)y, (float*)s_local, H, G, Q, P, N);
  return (int)cudaGetLastError();
}
