// flash_attention.cu: forward GQA attention with an online softmax, fp32,
// causal or bidirectional, optional logit soft-cap and sliding window.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (Pallas body _flash_kernel).  The JAX stream MLLM
// computes the same function in plain jnp (models/attention.py,
// full_attention via attend_prefill); the port's MLLM calls this kernel.
//
// Layout: the model's own, q/o (B, S, H, D) and k/v (B, S, Hk, D), all
// contiguous.  GQA puts G = H/Hk consecutive query heads on one kv head.
//
// Bound on an H100: 4*D fp32 operations per visible (query, key) pair and
// 4 bytes per element of q, k, v and o.  At the MLLM's full-frame shape
// (B=16, S=140, H=8, Hk=4, D=32, causal) that is 162 MFLOP against 6.9 MB,
// 23.5 operations per byte, just above the fp32 CUDA-core ridge (67 TFLOP/s
// over 3.35 TB/s = 20): operations bound it at about 2.4 us, bytes at
// 2.1 us.  Launch latency is of the same order.
//
// Design: one block per (query tile, kv head, batch row).  The tile holds
// the G*BQ query rows (G heads x BQ positions, at most 64 rows) that share
// the kv head, so K/V are read from device memory once per tile.  Each of
// the 8 warps owns 8 rows and keeps their running max m, sum l and output
// accumulator in registers.  K/V stream through shared memory in tiles of 32
// keys; in a tile, lane j scores key j against the row (q from shared
// memory, broadcast), the warp reduces max and sum with shuffles, and the
// P*V product broadcasts p_j lane to lane while each lane owns D/32 output
// columns.  At D = 256 the block's shared memory is 4 x (64 x 256 +
// 2 x 32 x 257) = 131,328 bytes, above the 48 KB default, so the launch
// raises the kernel's dynamic shared memory limit first (at D = 96 too:
// 49,408 bytes).  At G = 16 (chatglm3, glm4) a tile holds 4 positions of
// its 16 heads.  Key tiles entirely above the causal diagonal or below the
// window are never loaded; ragged edges (any S, not a multiple of the tile) are
// masked in the kernel, never padded, so the softmax of real rows sees only
// real keys.  Everything is fp32 on CUDA cores: the tensor cores' TF32 would
// lose the fp32 tolerance the plain version is held to.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                       // keys per tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int Hk, int G, int BQ, int causal, float cap,
                 int window, float scale) {
  constexpr int DT = (D + 31) / 32;  // output columns per lane
  constexpr int KP = D + 1;          // padded K/V row: lane j reads row j
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kRows][D]
  float* k_s = q_s + kRows * D;      // [kBK][KP]
  float* v_s = k_s + kBK * KP;       // [kBK][KP]

  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int R = G * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // query rows: row r = g*BQ + i is position q0+i of head hk*G+g
  for (int e = threadIdx.x; e < R * D; e += kWarps * 32) {
    const int r = e / D, d = e % D, g = r / BQ, pos = q0 + r % BQ;
    q_s[e] = pos < S ? q[(((size_t)b * S + pos) * H + hk * G + g) * D + d]
                     : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DT];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.0f;
  }

  // keys any row of this tile can see
  const int kend = causal ? min(S, q0 + BQ) : S;
  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  kbeg -= kbeg % kBK;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int e = threadIdx.x; e < kBK * D; e += kWarps * 32) {
      const int j = e / D, d = e % D, pos = k0 + j;
      const size_t src = (((size_t)b * S + pos) * Hk + hk) * D + d;
      k_s[j * KP + d] = pos < S ? k[src] : 0.0f;
      v_s[j * KP + d] = pos < S ? v[src] : 0.0f;
    }
    __syncthreads();
    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qpos = q0 + r % BQ;
      if (r >= R || qpos >= S) continue;  // warp-uniform
      const bool valid = kpos < S && (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
      float s = -INFINITY;
      if (valid) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + lane * KP;
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (cap > 0.0f) s = cap * tanhf(s / cap);
      }
      const float tmax = warp_max(s);
      if (tmax == -INFINITY) continue;  // no visible key in this tile
      const float m_new = fmaxf(m[rr], tmax);
      const float alpha = expf(m[rr] - m_new);  // 0 on the first visible tile
      const float p = valid ? expf(s - m_new) : 0.0f;
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[rr][t] *= alpha;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[rr][t] = fmaf(pj, v_s[j * KP + d], acc[rr][t]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int qpos = q0 + r % BQ, g = r / BQ;
    if (r >= R || qpos >= S) continue;
    float* orow = o + (((size_t)b * S + qpos) * H + hk * G + g) * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = acc[rr][t] / l[rr];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int Hk, int causal, float cap, int window,
           cudaStream_t stream) {
  const int G = H / Hk;
  const int BQ = kRows / G;
  const size_t smem = sizeof(float) * (kRows * D + 2 * kBK * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + BQ - 1) / BQ, Hk, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, o, S, H, Hk, G, BQ, causal, cap, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o (B, S, H, D), k/v (B, S, Hk, D) float32 contiguous.  cap <= 0 means
// no soft-cap, window <= 0 no sliding window.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hk, int D, int causal,
                                   float cap, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || H / Hk > kRows || B > 65535 ||
      Hk > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 32: return launch<32>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 64: return launch<64>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 96: return launch<96>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 128: return launch<128>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    case 256: return launch<256>(qf, kf, vf, of, B, S, H, Hk, causal, cap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
