// fused_prefix.cu: a plan's whole pixel prefix in one pass per frame: the
// frame-diff activity grid, one near-colour fraction per cheap filter, the
// cropped / downscaled / normalized frame, and the signature patch means.
//
// Replaces: src/repro/kernels/fused_prefix/kernel.py, fused_prefix_kernel
// (Pallas body _prefix_kernel, one program per frame walking a static
// stage tuple).
//
// Bound on an H100: bytes.  The function reads each frame and its
// predecessor once and writes the transformed frame and a few statistics;
// it does a handful of operations per byte.  At the main path's shape
// (B=16 uint8 3x128x256 frames and predecessors, diff 4x8, preprocess crop
// 64x256 /2, one colour, signature 8x16 on the 3x32x128 result) that is
// 3.15 MB read and 0.81 MB written, about 1.2 us at 3.35 TB/s.
//
// Design: one block per frame walks the stages in plan order.  The spec is
// a small descriptor passed by value (struct Spec); the wrapper has already
// resolved every crop into a window of one of four buffers (the input,
// the output frame x, two scratch frames), so a stage reads a view and
// never copies a crop.  A preprocess stage writes its frame to global
// memory (to x, or to scratch when a later stage crops it) and the stages
// after it read it back after __syncthreads(): an intermediate frame of
// 3x128x256 floats does not fit in shared memory.  Per-frame choices (raw
// vs normalized) need the frame's max first, so colour and signature take
// a block-wide max, then count or pool.  All reductions have a fixed order
// (integers for uint8 sums, so the diff is exact), and the preprocess
// arithmetic is fused_preprocess.cu's (preprocess.cuh), so the fused and
// the unfused chain write the same frames.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "preprocess.cuh"

// The descriptor is outside the anonymous namespace: the C entry point
// takes it, and a type with internal linkage would hide that symbol.
namespace prefix {

constexpr int kMaxStages = 16;  // kernel.py MAX_STAGES

// One stage, resolved by the wrapper (kernel.py: Stage).  A stage reads
// the window (y0, x0, h, w) of buffer `src`, whose frames are
// (C, src_h, src_w); a preprocess stage writes (C, dst_h, dst_w) to `dst`.
// a, b: diff regions (ry, rx) or signature grid (gy, gx); idx: colour slot.
struct Stage {
  int kind, src, src_h, src_w, y0, x0, h, w, dst, dst_h, dst_w, factor, grey,
      a, b, idx;
  float rgb[3];
};

struct Spec {
  int n;
  Stage st[kMaxStages];
};

}  // namespace prefix

namespace {

using prefix::Spec;
using prefix::Stage;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

enum Kind { kDiff = 0, kColor = 1, kPreprocess = 2, kSignature = 3, kCopy = 4 };
enum Buffer { kInput = 0, kOut = 1, kScratch0 = 2, kScratch1 = 3 };

// One frame's buffers.
template <typename T>
struct Frame {
  const T* in;
  const T* prev;
  void* out;  // T without a preprocess stage, else float
  float* scratch[2];

  __device__ float* buf(int id) const {
    return id == kOut ? static_cast<float*>(out) : scratch[id - kScratch0];
  }
  // element (c, y, x) of the stage's window, as float
  __device__ float at(const Stage& s, int c, int y, int x) const {
    const size_t off = ((size_t)c * s.src_h + s.y0 + y) * s.src_w + s.x0 + x;
    if (s.src == kInput) return (float)__ldg(in + off);
    return buf(s.src)[off];
  }
};

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
template <typename V>
struct Sum {
  __device__ V operator()(V a, V b) const { return a + b; }
};

// Block-wide reduction in a fixed order; every thread gets the result.
template <typename V, typename Op>
__device__ V block_reduce(V v, V* sh, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < kWarps; ++i) v = op(v, sh[i]);
  __syncthreads();  // sh is reused by the next reduction
  return v;
}

template <typename T>
__device__ float window_max(const Frame<T>& f, const Stage& s, int C,
                            float* sh) {
  const int n = C * s.h * s.w;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = i % s.w, t = i / s.w;
    m = fmaxf(m, f.at(s, t / s.h, t % s.h, x));
  }
  return block_reduce(m, sh, Max());
}

// diff: (ry, rx) grid of mean |cur - prev| / 255 over the whole frame.
// tpr threads share one region; each sums a strided part of it, and the
// first of them adds the parts in order.
template <typename T>
__device__ void diff_stage(const Frame<T>& f, const Stage& s, int C, int vec,
                           float* out, float* shf, unsigned* shu) {
  const int H = s.src_h, W = s.src_w, RY = s.a, RX = s.b;
  const int rh = H / RY, rw = W / RX, nreg = RY * RX;
  const int tpr = max(1, kThreads / nreg), groups = kThreads / tpr;
  const int group = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  const bool v16 = kU8 && vec && rw % 16 == 0;
  for (int r0 = 0; r0 < nreg; r0 += groups) {
    const int r = r0 + group;
    const bool active = group < groups && r < nreg;
    const int y0 = active ? (r / RX) * rh : 0, x0 = active ? (r % RX) * rw : 0;
    unsigned acc_u = 0;
    float acc_f = 0.0f;
    if (active && v16) {
      const int vw = rw / 16, n = C * rh * vw;
      for (int j = lane; j < n; j += tpr) {
        const int xv = j % vw, t = j / vw, y = t % rh, c = t / rh;
        const size_t off = ((size_t)c * H + y0 + y) * W + x0 + xv * 16;
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(f.in + off));
        const uint4 p = __ldg(reinterpret_cast<const uint4*>(f.prev + off));
        acc_u += __vsadu4(a.x, p.x) + __vsadu4(a.y, p.y) +
                 __vsadu4(a.z, p.z) + __vsadu4(a.w, p.w);
      }
    } else if (active) {
      const int n = C * rh * rw;
      for (int j = lane; j < n; j += tpr) {
        const int x = j % rw, t = j / rw, y = t % rh, c = t / rh;
        const size_t off = ((size_t)c * H + y0 + y) * W + x0 + x;
        if constexpr (kU8) {
          acc_u += (unsigned)abs((int)__ldg(f.in + off) -
                                 (int)__ldg(f.prev + off));
        } else {
          acc_f += fabsf(__ldg(f.in + off) - __ldg(f.prev + off));
        }
      }
    }
    shu[threadIdx.x] = acc_u;
    shf[threadIdx.x] = acc_f;
    __syncthreads();
    if (active && lane == 0) {
      const double n = 255.0 * (double)C * rh * rw;
      if constexpr (kU8) {
        unsigned tot = 0;
        for (int k = 0; k < tpr; ++k) tot += shu[threadIdx.x + k];
        out[r] = (float)((double)tot / n);
      } else {
        float tot = 0.0f;
        for (int k = 0; k < tpr; ++k) tot += shf[threadIdx.x + k];
        out[r] = (float)((double)tot / n);
      }
    }
    __syncthreads();
  }
}

// colour: fraction of the window's pixels within RGB distance 70 of the
// target; a window whose max is <= 8 holds normalized values and is mapped
// back to 0..255 first.  Products and sums are rounded one by one, in the
// plain version's order, so the per-pixel decision is the same.
template <typename T>
__device__ void color_stage(const Frame<T>& f, const Stage& s, int C,
                            float* out, float* shf, unsigned* shu) {
  const bool norm = window_max(f, s, C, shf) <= 8.0f;
  const int hw = s.h * s.w;
  unsigned cnt = 0;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const int x = i % s.w, y = i / s.w;
    float d2 = 0.0f;
    for (int c = 0; c < C; ++c) {
      float v = f.at(s, c, y, x);
      if (norm) v = __fmul_rn(__fadd_rn(__fmul_rn(v, 0.25f), 0.5f), 255.0f);
      const float e = __fsub_rn(v, s.rgb[c]);
      d2 = c == 0 ? __fmul_rn(e, e) : __fadd_rn(d2, __fmul_rn(e, e));
    }
    cnt += sqrtf(d2) < 70.0f ? 1u : 0u;
  }
  cnt = block_reduce(cnt, shu, Sum<unsigned>());
  if (threadIdx.x == 0) out[s.idx] = (float)cnt * (1.0f / (float)hw);
}

// preprocess: f x f area mean of the window, (v - 0.5) / 0.25 per channel,
// or the luminance of the three written to every channel (grey).
template <typename T>
__device__ float window_mean(const Frame<T>& f, const Stage& s, int c, int y,
                             int x) {
  const int k = s.factor;
  if constexpr (std::is_same<T, uint8_t>::value) {
    if (s.src == kInput) {  // exact integer sum, as fused_preprocess.cu
      const uint8_t* p =
          f.in + ((size_t)c * s.src_h + s.y0 + y) * s.src_w + s.x0 + x;
      unsigned sum = 0;
      for (int dy = 0; dy < k; ++dy)
        for (int dx = 0; dx < k; ++dx) sum += __ldg(p + (size_t)dy * s.src_w + dx);
      return pixel::area_mean((float)sum, k);
    }
  }
  float sum = 0.0f;
  for (int dy = 0; dy < k; ++dy)
    for (int dx = 0; dx < k; ++dx) sum += f.at(s, c, y + dy, x + dx);
  return pixel::area_mean(sum, k);
}

template <typename T>
__device__ void preprocess_stage(const Frame<T>& f, const Stage& s, int C) {
  const int Ho = s.dst_h, Wo = s.dst_w, k = s.factor;
  const size_t plane = (size_t)Ho * Wo;
  float* dst = f.buf(s.dst);
  const int n = (s.grey ? 1 : C) * Ho * Wo;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ox = i % Wo, t = i / Wo, oy = t % Ho, co = t / Ho;
    const size_t o = (size_t)oy * Wo + ox;
    if (!s.grey) {
      dst[co * plane + o] = pixel::normalize(
          window_mean(f, s, co, oy * k, ox * k), 0.5f, 0.25f);
      continue;
    }
    float v[3];
    for (int c = 0; c < 3; ++c)
      v[c] = pixel::normalize(window_mean(f, s, c, oy * k, ox * k), 0.5f,
                              0.25f);
    const float g = pixel::luma(v[0], v[1], v[2]);
    for (int c = 0; c < C; ++c) dst[c * plane + o] = g;
  }
}

// signature: (gy, gx) patch means per channel of the window; a window
// whose max is > 8 holds raw values and is normalized first.
template <typename T>
__device__ void signature_stage(const Frame<T>& f, const Stage& s, int C,
                                float* out, float* shf) {
  const bool raw = window_max(f, s, C, shf) > 8.0f;
  const int gy = s.a, gx = s.b, ph = s.h / gy, pw = s.w / gx;
  for (int p = threadIdx.x; p < C * gy * gx; p += kThreads) {
    const int px = p % gx, t = p / gx, py = t % gy, c = t / gy;
    float sum = 0.0f;
    for (int dy = 0; dy < ph; ++dy)
      for (int dx = 0; dx < pw; ++dx) {
        float v = f.at(s, c, py * ph + dy, px * pw + dx);
        if (raw) v = (v / 255.0f - 0.5f) / 0.25f;
        sum += v;
      }
    out[p] = sum * (1.0f / (float)(ph * pw));
  }
}

// copy: the final window to x (input type without a preprocess stage).
template <typename T>
__device__ void copy_stage(const Frame<T>& f, const Stage& s, int C) {
  const int n = C * s.h * s.w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = i % s.w, t = i / s.w, y = t % s.h, c = t / s.h;
    const size_t o = ((size_t)c * s.h + y) * s.w + x;
    if (s.src == kInput) {
      const size_t off = ((size_t)c * s.src_h + s.y0 + y) * s.src_w + s.x0 + x;
      static_cast<T*>(f.out)[o] = f.in[off];
    } else {
      static_cast<float*>(f.out)[o] = f.at(s, c, y, x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_prefix_kernel(const T* __restrict__ frames, const T* __restrict__ prevs,
                    float* d, float* fracs, void* x, float* feats,
                    float* scratch, int B, int C, int H, int W,
                    long long out_frame, int out_is_float, int nreg,
                    int ncolor, int sig_d, long long scratch_frame, int vec,
                    Spec spec) {
  __shared__ float shf[kThreads];
  __shared__ unsigned shu[kThreads];
  const int b = blockIdx.x;
  const size_t in_frame = (size_t)C * H * W;
  Frame<T> f;
  f.in = frames + b * in_frame;
  f.prev = prevs ? prevs + b * in_frame : nullptr;
  f.out = out_is_float ? (void*)(static_cast<float*>(x) + b * out_frame)
                       : (void*)(static_cast<T*>(x) + b * out_frame);
  f.scratch[0] = scratch ? scratch + (size_t)b * scratch_frame : nullptr;
  f.scratch[1] = scratch ? scratch + ((size_t)B + b) * scratch_frame : nullptr;
  for (int i = 0; i < spec.n; ++i) {
    const Stage s = spec.st[i];
    switch (s.kind) {
      case kDiff:
        diff_stage(f, s, C, vec, d + (size_t)b * nreg, shf, shu);
        break;
      case kColor:
        color_stage(f, s, C, fracs + (size_t)b * ncolor, shf, shu);
        break;
      case kPreprocess:
        preprocess_stage(f, s, C);
        break;
      case kSignature:
        signature_stage(f, s, C, feats + (size_t)b * sig_d, shf);
        break;
      default:
        copy_stage(f, s, C);
    }
    __syncthreads();  // the next stage may read what this one wrote
  }
}

}  // namespace

// frames, prevs (B, C, H, W) uint8 (is_float 0) or float32 (1), contiguous;
// prevs only with a diff stage.  Outputs: d (B, nreg), fracs (B, ncolor),
// x (B, out_frame) float32 when out_is_float else the input type, feats
// (B, sig_d), scratch (2, B, scratch_frame) float32; any may be null when
// no stage writes it.  `spec` is read on the host at launch.
extern "C" int fused_prefix_launch(const void* frames, const void* prevs,
                                   int is_float, void* d, void* fracs, void* x,
                                   void* feats, void* scratch, int B, int C,
                                   int H, int W, long long out_frame,
                                   int out_is_float, int nreg, int ncolor,
                                   int sig_d, long long scratch_frame,
                                   const Spec* spec, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || spec == nullptr ||
      spec->n <= 0 || spec->n > prefix::kMaxStages || x == nullptr)
    return (int)cudaErrorInvalidValue;
  const int vec = (W % 16 == 0) && ((uintptr_t)frames % 16 == 0) &&
                  (prevs == nullptr || (uintptr_t)prevs % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    fused_prefix_kernel<float><<<B, kThreads, 0, st>>>(
        (const float*)frames, (const float*)prevs, (float*)d, (float*)fracs,
        x, (float*)feats, (float*)scratch, B, C, H, W, out_frame, out_is_float,
        nreg, ncolor, sig_d, scratch_frame, vec, *spec);
  } else {
    fused_prefix_kernel<uint8_t><<<B, kThreads, 0, st>>>(
        (const uint8_t*)frames, (const uint8_t*)prevs, (float*)d,
        (float*)fracs, x, (float*)feats, (float*)scratch, B, C, H, W,
        out_frame, out_is_float, nreg, ncolor, sig_d, scratch_frame, vec,
        *spec);
  }
  return (int)cudaGetLastError();
}
