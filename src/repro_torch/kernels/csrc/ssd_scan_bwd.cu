// ssd_scan_bwd.cu: the gradient of ssd_scan.cu's within-chunk terms, fp32.
//
// Replaces no Pallas kernel: the JAX package differentiates its plain jnp
// SSD (models/ssm.py, _ssd_chunked) with jax.grad, so the gradient of the
// kernel at src/repro/kernels/ssd_scan/kernel.py:55 has no TPU kernel of
// its own.  The port trains its Mamba2 layers (mamba2-130m, jamba's) through
// kernels/ssd_scan/ops.py::SSDScanFn, whose backward calls this.
//
// Per (chunk bc, head h), group g = h / (H / G), with L_ij = exp(cs_i -
// cs_j) for i >= j (0 above the diagonal, where nothing is exponentiated),
// CB_ij = C_i . B_j, W_ij = CB_ij L_ij dt_j, e_j = exp(cs_{Q-1} - cs_j) and
// w_j = e_j dt_j, given dy (Q, P) and ds (N, P), the gradients of
//   y_diag[i, p] = sum_{j <= i} W_ij x[j, p]
//   s_local[n, p] = sum_j B[j, n] w_j x[j, p]
// are, with dM_ij = dy_i . x_j, T_ij = dM_ij CB_ij L_ij, V_j = B_j ds (P)
// and u_j = V_j . x_j:
//   dx_j  = sum_i W_ij dy_i + w_j V_j
//   dC_i  = sum_j dM_ij L_ij dt_j B_j                 summed over the
//   dB_j  = sum_i dM_ij L_ij dt_j C_i + w_j (ds x_j)  group's heads
//   ddt_j = sum_i T_ij + e_j u_j
//   dcs_k = sum_j T_kj dt_j - dt_k sum_i T_ik - w_k u_k
//           (+ sum_j w_j u_j at k = Q-1)
// Layout (the forward's): x, dy, dx (BC, H, Q, P); B, C, dB, dC (BC, G, Q,
// N); cs, dt, dcs, ddt (BC, H, 1, Q); ds (BC, H, N, P).
//
// Bound on an H100: operations.  At mamba2-130m's training micro-batch
// (4 sequences of 512 tokens: 8 chunks of Q 256, 24 heads in one group,
// N 128, P 64) the products need 3.4 GFLOP (C.B^T once a group, dy.x^T,
// W^T.dy, the head-summed dCB against B and C, B.ds and ds.x^T): 21 us at
// 3xTF32 (a third of the TF32 rate), against 48 MB moved (14 us).
//
// Design (a first, simple kernel): one launch of two kinds of block, each
// owning one (chunk, head) and one 32-row tile: a column block owns the
// keys j of its tile and walks the row tiles i >= j (dx, this head's dB,
// ddt and dcs's column terms, then the s_local terms through ds's rows, 32
// state dims at a time); a row block owns rows i and walks the key tiles
// j <= i (this head's dC and dcs's row terms).  Each tile recomputes
// C.B^T, dy.x^T and L in the block: nothing Q x Q is saved by the forward
// or written here.  Tiles are copied to shared memory 16 bytes a thread
// where the rows allow.  Each head's dB and dC go to scratch; a second
// launch sums them over the group's heads in head order, adds dcs's row
// terms (one block's) to its column terms (another's), and adds at Q-1
// the s_local term's sum from the column blocks' partials in tile order.
// Every sum has a fixed order and no float atomics, so two launches agree
// bit for bit.  A block a head, not a group: a block walking a group's
// heads summed dB and dC in shared memory but left mamba2's training shape
// 128 blocks of up to 192 tiles (2.8x slower on an H100 80GB HBM3 at
// 700 W).  Every product runs on the
// tensor cores, TF32 mma.sync.m16n8k8 on operands split as their
// fragments are read (ssd_scan.cu's and flash_attention.cu's arithmetic):
// 3xTF32 (hi*hi + hi*lo + lo*hi), hi*hi of each 8-wide k-step in a fresh
// accumulator added with fp32 adds; a product's 16x8 output tiles are
// dealt to the 8 warps in turn, so each element has one owner and the
// sums need no atomics.
// Any Q up to 256: rows and keys past Q are zero-filled and masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;               // rows of a tile, keys of a tile
constexpr int kLT = kT + 1;          // row stride of a 32 x 32 tile

// x = hi + lo exactly: hi is x rounded to 11 significant bits (a TF32
// value), by Veltkamp's split in fp32 arithmetic (ssd_scan.cu's)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out(r, c, v) for r < 32 and c < ncols, v = sum_{k < K} a(r, k) b(k, c);
// ncols and K multiples of 8.  3xTF32 on operands split as they are read
// (A fragment: rows g, g+8 at k-columns t, t+4; B fragment: k-rows t, t+4
// at column g), hi*hi of each k-step in a fresh accumulator added to the
// sum with an fp32 add.  The 16x8 output tiles go to the warps in turn:
// each element is computed and handed to `out` by one thread.
template <class FA, class FB, class FO>
__device__ __forceinline__ void block_mm(int ncols, int K, FA a, FB b,
                                         FO out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = 2 * (ncols >> 3);
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int r0 = (tile & 1) * 16, c0 = (tile >> 1) * 8;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float accx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ahi[4], alo[4], bh0, bl0, bh1, bl1;
      split(a(r0 + g, k0 + t), ahi[0], alo[0]);
      split(a(r0 + g + 8, k0 + t), ahi[1], alo[1]);
      split(a(r0 + g, k0 + t + 4), ahi[2], alo[2]);
      split(a(r0 + g + 8, k0 + t + 4), ahi[3], alo[3]);
      split(b(k0 + t, c0 + g), bh0, bl0);
      split(b(k0 + t + 4, c0 + g), bh1, bl1);
      float tt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma(accx, alo, bh0, bh1);
      mma(accx, ahi, bl0, bl1);
      mma(tt, ahi, bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += tt[e];
    }
    out(r0 + g, c0 + 2 * t, acc[0] + accx[0]);
    out(r0 + g, c0 + 2 * t + 1, acc[1] + accx[1]);
    out(r0 + g + 8, c0 + 2 * t, acc[2] + accx[2]);
    out(r0 + g + 8, c0 + 2 * t + 1, acc[3] + accx[3]);
  }
}

// rows row0 .. row0+31 (< rmax) and columns 0 .. width-1 (< cmax) of a
// row-major source of row stride `stride` into dst (row stride ld); zeros
// elsewhere.  `vec`: 16-byte copies (stride, cmax, width and ld multiples
// of 4, the source 16-byte aligned)
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int stride, int row0, int rmax,
                                          int cmax, int width, bool vec) {
  if (vec) {
    const int per = width / 4;
    for (int e = threadIdx.x; e < kT * per; e += kThreads) {
      const int r = e / per, c = (e % per) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row0 + r < rmax && c < cmax)
        v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) *
                                                       stride + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, c = e % width;
    dst[r * ld + c] = row0 + r < rmax && c < cmax
        ? src[(size_t)(row0 + r) * stride + c] : 0.0f;
  }
}

// entries row0 .. row0+31 (< n) of a vector into dst, zeros past n; threads
// 0-31
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n) {
  if (threadIdx.x < kT)
    dst[threadIdx.x] = row0 + (int)threadIdx.x < n ? src[row0 + threadIdx.x]
                                                   : 0.0f;
}

__device__ __forceinline__ void zero(float* dst, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = 0.0f;
}

// the shared-memory layout, in floats: three tiles of N state dims (B's
// rows, C's rows, the group's dB or dC), four of P columns (x's rows, dy's
// or ds's rows, dx, V), three 32 x 32 tiles and eight vectors of 32: 99 KB
// at mamba2-130m's N 128 and P 64, 181 KB at the largest N and P
struct Layout {
  int NK, PK, LN, LP;
  __host__ __device__ Layout(int N, int P)
      : NK((N + 7) / 8 * 8), PK((P + 7) / 8 * 8), LN(NK + 4), LP(PK + 4) {}
  __host__ __device__ int total() const {
    return 3 * kT * LN + 4 * kT * LP + 3 * kT * kLT + 8 * kT;
  }
};

__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ cs,
                    const float* __restrict__ dt, const float* __restrict__ dy,
                    const float* __restrict__ ds, float* __restrict__ dx,
                    float* __restrict__ pdb, float* __restrict__ pdc,
                    float* __restrict__ dcs, float* __restrict__ ddt,
                    float* __restrict__ dcs_row, float* __restrict__ esum,
                    int H, int G, int Q, int P, int N, bool vec) {
  const Layout L(N, P);
  const int NK = L.NK, PK = L.PK, LN = L.LN, LP = L.LP;
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                  // [kT][LN] B's key rows
  float* sC = sB + kT * LN;          // [kT][LN] C's rows
  float* sAN = sC + kT * LN;         // [kT][LN] dB (column) or dC (row block)
  float* sX = sAN + kT * LN;         // [kT][LP] x's key rows
  float* sDY = sX + kT * LP;         // [kT][LP] dy's rows, then ds's
  float* sAP = sDY + kT * LP;        // [kT][LP] dx's sum over rows
  float* sV = sAP + kT * LP;         // [kT][LP] B_j ds
  float* sCB = sV + kT * LP;         // [kT][kLT] C.B^T, then W
  float* sDM = sCB + kT * kLT;       // [kT][kLT] dy.x^T, then dM L dt
  float* sTT = sDM + kT * kLT;       // [kT][kLT] T (column) or T dt (row)
  float* csi = sTT + kT * kLT;       // [kT] cs of the rows
  float* csj = csi + kT;             // [kT] cs of the keys
  float* dtj = csj + kT;             // [kT] dt of the keys
  float* acc = dtj + kT;             // [kT] column sums of T / row sums of T dt
  float* ej = acc + kT;              // [kT] e_j
  float* wj = ej + kT;               // [kT] w_j
  float* wu = wj + kT;               // [kT] w_j u_j

  const int nt = (Q + kT - 1) / kT;
  const int h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  const bool col = (int)blockIdx.x < nt;
  const int tile = col ? blockIdx.x : blockIdx.x - nt;
  const int t0 = tile * kT;          // the block's keys (column) or rows
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bc * H + h;
  const float* bg = bm + ((size_t)bc * G + g) * Q * N;
  const float* cg = cm + ((size_t)bc * G + g) * Q * N;
  const float* xh = x + bh * Q * P;
  const float* dyh = dy + bh * Q * P;
  const float* csh = cs + bh * Q;
  const float* dth = dt + bh * Q;

  zero(sAN, kT * LN);
  if (tid < kT) acc[tid] = 0.0f;
  if (col) {
    load_tile(sB, LN, bg, N, t0, Q, N, NK, vec);
    load_tile(sX, LP, xh, P, t0, Q, P, PK, vec);
    zero(sAP, kT * LP);
    zero(sV, kT * LP);
    load_vec(csj, csh, t0, Q);
    load_vec(dtj, dth, t0, Q);
  } else {
    load_tile(sC, LN, cg, N, t0, Q, N, NK, vec);
    load_tile(sDY, LP, dyh, P, t0, Q, P, PK, vec);
    load_vec(csi, csh, t0, Q);
  }
  // the other tiles: rows i >= the keys (column) or keys j <= the rows
  const int first = col ? tile : 0, last = col ? nt - 1 : tile;
  for (int ot = first; ot <= last; ++ot) {
    const int o0 = ot * kT;
    const int i0 = col ? o0 : t0, j0 = col ? t0 : o0;
    __syncthreads();                 // the previous tile is consumed
    if (col) {
      load_tile(sC, LN, cg, N, o0, Q, N, NK, vec);
      load_tile(sDY, LP, dyh, P, o0, Q, P, PK, vec);
      load_vec(csi, csh, o0, Q);
    } else {
      load_tile(sB, LN, bg, N, o0, Q, N, NK, vec);
      load_tile(sX, LP, xh, P, o0, Q, P, PK, vec);
      load_vec(csj, csh, o0, Q);
      load_vec(dtj, dth, o0, Q);
    }
    __syncthreads();
    // C.B^T and dy.x^T: rows i, keys j
    block_mm(kT, NK, [&](int r, int k) { return sC[r * LN + k]; },
             [&](int k, int c) { return sB[c * LN + k]; },
             [&](int r, int c, float v) { sCB[r * kLT + c] = v; });
    block_mm(kT, PK, [&](int r, int k) { return sDY[r * LP + k]; },
             [&](int k, int c) { return sX[c * LP + k]; },
             [&](int r, int c, float v) { sDM[r * kLT + c] = v; });
    __syncthreads();
    // W, dM L dt and T; L only where j <= i < Q
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      const int i = i0 + r, j = j0 + c;
      float w = 0.0f, dcb = 0.0f, tt = 0.0f;
      if (i < Q && j <= i) {
        const float l = expf(csi[r] - csj[c]);
        const float cb = sCB[r * kLT + c], dm = sDM[r * kLT + c];
        w = cb * l * dtj[c];
        dcb = dm * l * dtj[c];
        tt = dm * cb * l;
      }
      sCB[r * kLT + c] = w;
      sDM[r * kLT + c] = dcb;
      sTT[r * kLT + c] = col ? tt : tt * dtj[c];
    }
    __syncthreads();
    if (col) {
      // dx_j += W^T dy_i; dB_j += (dM L dt)^T C_i; column sums of T
      block_mm(PK, kT, [&](int r, int k) { return sCB[k * kLT + r]; },
               [&](int k, int c) { return sDY[k * LP + c]; },
               [&](int r, int c, float v) { sAP[r * LP + c] += v; });
      block_mm(NK, kT, [&](int r, int k) { return sDM[k * kLT + r]; },
               [&](int k, int c) { return sC[k * LN + c]; },
               [&](int r, int c, float v) { sAN[r * LN + c] += v; });
      if (tid < kT) {
        float s = 0.0f;
        for (int r = 0; r < kT; ++r) s += sTT[r * kLT + tid];
        acc[tid] += s;
      }
    } else {
      // dC_i += (dM L dt) B_j; row sums of T dt
      block_mm(NK, kT, [&](int r, int k) { return sDM[r * kLT + k]; },
               [&](int k, int c) { return sB[k * LN + c]; },
               [&](int r, int c, float v) { sAN[r * LN + c] += v; });
      if (tid < kT) {
        float s = 0.0f;
        for (int c = 0; c < kT; ++c) s += sTT[tid * kLT + c];
        acc[tid] += s;
      }
    }
  }
  // this head's dB (column) or dC (row block) partial, summed over the
  // group's heads in order by the second launch
  float* part = (col ? pdb : pdc) + bh * Q * N;
  if (!col) {
    __syncthreads();
    if (tid < kT && t0 + tid < Q) dcs_row[bh * Q + t0 + tid] = acc[tid];
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, c = e % N;
      if (t0 + r < Q) part[(size_t)(t0 + r) * N + c] = sAN[r * LN + c];
    }
    return;
  }
  // s_local's terms: V_j = B_j ds and w_j (ds x_j), ds's rows 32 state
  // dims at a time through sDY
  __syncthreads();
  if (tid < kT) {
    ej[tid] = t0 + tid < Q ? expf(csh[Q - 1] - csj[tid]) : 0.0f;
    wj[tid] = ej[tid] * dtj[tid];
  }
  const float* dsh = ds + bh * N * P;
  for (int n0 = 0; n0 < NK; n0 += kT) {
    const int kn = min(kT, NK - n0);
    __syncthreads();                 // sDY is free
    load_tile(sDY, LP, dsh, P, n0, N, P, PK, vec);
    __syncthreads();
    block_mm(PK, kn, [&](int r, int k) { return sB[r * LN + n0 + k]; },
             [&](int k, int c) { return sDY[k * LP + c]; },
             [&](int r, int c, float v) { sV[r * LP + c] += v; });
    block_mm(kn, PK, [&](int r, int k) { return sX[r * LP + k]; },
             [&](int k, int c) { return sDY[c * LP + k]; },
             [&](int r, int c, float v) {
               sAN[r * LN + n0 + c] += wj[r] * v;
             });
  }
  __syncthreads();
  float* dxh = dx + bh * Q * P;
  for (int e = tid; e < kT * P; e += kThreads) {
    const int r = e / P, c = e % P;
    if (t0 + r < Q)
      dxh[(size_t)(t0 + r) * P + c] = sAP[r * LP + c] + wj[r] * sV[r * LP + c];
  }
  for (int e = tid; e < kT * N; e += kThreads) {
    const int r = e / N, c = e % N;
    if (t0 + r < Q) part[(size_t)(t0 + r) * N + c] = sAN[r * LN + c];
  }
  if (tid < kT) {
    float u = 0.0f;
    for (int c = 0; c < P; ++c) u += sV[tid * LP + c] * sX[tid * LP + c];
    wu[tid] = wj[tid] * u;
    if (t0 + tid < Q) {
      ddt[bh * Q + t0 + tid] = acc[tid] + ej[tid] * u;
      dcs[bh * Q + t0 + tid] = -(dtj[tid] * acc[tid]) - wu[tid];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int r = 0; r < kT; ++r) s += wu[r];
    esum[bh * nt + tile] = s;
  }
}

// The second launch, a thread an output element: dB and dC, each head's
// partial summed over the group's heads in head order; dcs = its column
// terms (already in dcs) + its row terms + at Q-1 the s_local term's sum
// over the column tiles, in tile order
__global__ void ssd_scan_bwd_sums(const float* __restrict__ pdb,
                                  const float* __restrict__ pdc,
                                  float* __restrict__ db,
                                  float* __restrict__ dc,
                                  float* __restrict__ dcs,
                                  const float* __restrict__ dcs_row,
                                  const float* __restrict__ esum, int BC,
                                  int H, int G, int Q, int N) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nb = (size_t)BC * G * Q * N, ns = (size_t)BC * H * Q;
  const int rep = H / G;
  if (e < 2 * nb) {
    const bool is_b = e < nb;
    const size_t f = is_b ? e : e - nb;
    const size_t qn = f % ((size_t)Q * N), bg = f / ((size_t)Q * N);
    const float* part = (is_b ? pdb : pdc) +
                        (bg * rep) * (size_t)Q * N + qn;   // head g * rep
    float s = 0.0f;
    for (int hh = 0; hh < rep; ++hh) s += part[(size_t)hh * Q * N];
    (is_b ? db : dc)[f] = s;
  } else if (e < 2 * nb + ns) {
    const size_t f = e - 2 * nb;
    const size_t bh = f / Q;
    const int nt = (Q + kT - 1) / kT;
    float v = dcs[f] + dcs_row[f];
    if ((int)(f % Q) == Q - 1) {
      float s = 0.0f;
      for (int t = 0; t < nt; ++t) s += esum[bh * nt + t];
      v += s;
    }
    dcs[f] = v;
  }
}

}  // namespace

// x, dy (BC, H, Q, P), B/C (BC, G, Q, N), cs/dt (BC, H, 1, Q), ds (BC, H,
// N, P) float32 contiguous -> dx (BC, H, Q, P), dB/dC (BC, G, Q, N),
// dcs/ddt (BC, H, 1, Q); scratch: pdb and pdc (BC, H, Q, N), each head's
// partial, dcs_row (BC, H, Q) and esum (BC, H, ceil(Q / 32)).  Two
// launches on `stream`.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* bm, const void* cm,
                                const void* cs, const void* dt, const void* dy,
                                const void* ds, void* dx, void* db, void* dc,
                                void* dcs, void* ddt, void* pdb, void* pdc,
                                void* dcs_row, void* esum, int BC, int H,
                                int G, int Q, int P, int N, void* stream) {
  if (BC <= 0 || H <= 0 || G <= 0 || H % G || Q <= 0 || Q > 256 || P <= 0 ||
      P > 128 || N <= 0 || N > 256 || BC > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * (size_t)Layout(N, P).total();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies where every row allows
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
      ((((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm | (uintptr_t)dy |
         (uintptr_t)ds) & 15u) == 0);
  const int nt = (Q + kT - 1) / kT;
  ssd_scan_bwd_kernel<<<dim3(2 * nt, H, BC), kThreads, smem, st>>>(
      (const float*)x, (const float*)bm, (const float*)cm, (const float*)cs,
      (const float*)dt, (const float*)dy, (const float*)ds, (float*)dx,
      (float*)pdb, (float*)pdc, (float*)dcs, (float*)ddt, (float*)dcs_row,
      (float*)esum, H, G, Q, P, N, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = 2 * (size_t)BC * G * Q * N + (size_t)BC * H * Q;
  ssd_scan_bwd_sums<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)pdb, (const float*)pdc, (float*)db, (float*)dc,
      (float*)dcs, (const float*)dcs_row, (const float*)esum, BC, H, G, Q, N);
  return (int)cudaGetLastError();
}
