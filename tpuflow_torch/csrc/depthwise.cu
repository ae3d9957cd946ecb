// K7: one stage of PCBlock4's conv_list, the depthwise conv with its
// residual and activation, in one pass over memory:
//   y = act(x1 + b + dwconv_k(x1)),
//   x1 = x, or with the pointwise (k = 1) entry before it folded in:
//   x1 = round(act(x + pb + pw * x)).
//
// It replaces no TPU kernel: the JAX package left these convolutions to
// XLA (tpuflow/core/sk.py:20-21).  It was added because on an H100 cuDNN's
// grouped direct kernel ran them about 100x off their bound (364 ms of a
// 673 ms MemFlow 1080p frame), behind separate add and GELU passes and
// PyTorch's own depthwise kernel for the k = 1 entries.
//
// What it computes, for NHWC x [B, Hin, W, C] (bf16 or f32), weights
// [C, 1, k, k], bias [C] (both of x's dtype), k = 1, 7 or 15 (PCBlock4's
// sizes: each k is a template), and row pads (pt, pb) <= k / 2 (the width
// is always padded 'SAME', k / 2 each side):
//   y[b, r, c, ch] = act(x1[b, r - pt + k/2, c, ch]
//                        + (bias[ch] + sum_{i,j} w[ch, i, j] * x1p[b, r - pt + i, c - k/2 + j, ch]))
// for r < Hout = Hin + pt + pb - (k - 1), where x1p is x1 inside the input
// and 0 outside it (the padding applies to the value after the prologue,
// as the module pads the first entry's output).  act is GELU, the tanh form
// for bf16 and the exact erf form for f32 (core/encoders.gelu).  The sums
// are f32 and the result is rounded once to x's dtype; the prologue's x1
// is rounded once too, as the module stores it.  A strip of a spatially
// sharded frame passes the rows it fetched and the pads at the frame's
// edges (core/strips.depthwise_rows).  The plain version is
// tpuflow_torch/kernels/depthwise.py:depthwise_residual_gelu_plain.
//
// Bound on an H100.  On the CUDA cores, with f32 FMAs (67 TFLOP/s), the
// operations bound it: at MemFlow's 1080p grid (135 x 240) a 15 x 15 stage
// of C channels needs C * 32 400 * 225 FMAs against 2 * C * 32 400 * 2
// bytes of bf16 traffic (3.35 TB/s): 0.22 ms against 0.015 ms for C = 384,
// 3.5 ms a MemFlow frame in all.  The card's own bound is lower: its tensor
// cores multiply bf16 with f32 sums (wgmma, 989 TFLOP/s dense), and as a
// banded Toeplitz product, whose useful share of the operations is about
// 47 % at k = 15 and 16-column tiles, the stages are bound by their bytes:
// about 0.8 ms a MemFlow frame.
//
// Design: feed the FMA units from registers, so that shared memory reads
// and address arithmetic are a small share of the issued instructions.
// - A block takes a tile of kR = 16 output columns x TH rows x G channels
//   (bf16: G = 16, TH = 16; f32: G = 8, TH = 32), 128 threads.  It stages
//   the tile plus its (k - 1) halo, G channels a pixel (32 bytes), from the
//   NHWC tensor as it lies: 16-byte loads where C is a multiple of 8 (f32:
//   4) and the rows are aligned, 8-byte loads where C is a multiple of 4
//   (C = 324: a tail of 4 channels in the last group), else element by
//   element.  Positions outside the input, and channels >= C, stage zeros;
//   there is no padded copy.  The k x k weights of the group, the bias and
//   the prologue's weights are staged as f32.  Row pitches are padded so
//   that the four (f32: the half-warp's four) rows a warp reads lie in
//   distinct banks.
// - Each thread owns two channels of one output row's kR pixels and keeps
//   their 2 x kR f32 sums in registers.  For each kernel row it loads that
//   row's 2 x k weights into registers, then slides along the kR + k - 1
//   staged pixels of its input row: one 4-byte (f32: 8-byte) shared load
//   gives both channels of a pixel, which feed up to k outputs each:
//   2 * kR * k FMAs per kR + k - 1 input loads and k weight loads, fully
//   unrolled for each k, so the sums stay in registers.
// - The epilogue adds the bias and the residual (the staged center pixel),
//   applies the activation, rounds once and stores.
// No cp.async or TMA ring: staging is a small share of a block's work, and
// the five blocks that fit on an SM (44 KB of shared memory each for bf16
// 15 x 15) overlap one block's staging with the others' FMAs.
//
// What still holds it back (H100, MemFlow's 1080p stages): about 7 % of the
// card's bound a frame (the bytes), and 30-34 % of the FMA bound at 15 x 15
// and 22 % at 7 x 7.  FFMA is about two thirds of the issued instructions;
// the rest are the bf16 unpacks and shared loads of the product, and the
// staging, whose halo (and the prologue's GELU on it) each tile repeats: a
// 16 x 16 tile stages 30 x 30 pixels at 15 x 15.  The next design moves the
// products to wgmma (a banded Toeplitz weight operand per channel and
// kernel row).
//
// Bounds guards (bounds.cuh, checked build): every load of x, the weights,
// the bias and the prologue's weights, and every store of y, against its
// tensor's extent.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kR = 16;         // output columns of a tile: the pixels a thread slides along
constexpr int kThreads = 128;

struct Extents {
  long long x, w, bias, pre_w, pre_b, y;
};

template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr int kGroup = 16;  // channels of a block: 32 bytes a pixel
};
template <>
struct Traits<float> {
  using Pair = float2;
  static constexpr int kGroup = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 unpack(float2 p) { return p; }
__device__ __forceinline__ float2 unpack(__nv_bfloat162 p) { return __bfloat1622float2(p); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// core/encoders.gelu: the tanh form in bf16, the exact erf form in f32,
// evaluated in f32.  The tanh form is taken as its equal
//   0.5 v (1 + tanh(u)) = v / (1 + exp(-2u)),  u = sqrt(2/pi) (v + 0.044715 v^3),
// one exponential and one division, without the cancellation of 1 + tanh
// for negative v; it stays within a few f32 steps of PyTorch's tanh, far
// below bf16's.  Every rounding is explicit, so that the prologue and the
// epilogue, which both inline it, give the same bits for the same argument.
template <typename T>
__device__ __forceinline__ float act(float v);
template <>
__device__ __forceinline__ float act<__nv_bfloat16>(float v) {
  const float kMinus2Beta = -1.5957691216057308f;  // -2 sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(v, v), v);
  const float minus_2u = __fmul_rn(kMinus2Beta, __fmaf_rn(0.044715f, cube, v));
  return __fdividef(v, __fadd_rn(1.0f, __expf(minus_2u)));
}
template <>
__device__ __forceinline__ float act<float>(float v) {
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, erff(__fmul_rn(v, 0.7071067811865476f))));
}

// act(res + (bias + sum)) with explicit roundings: the epilogue of a k = 1
// stage (sum = w * x, one FMA on a zero sum) and the prologue give the same
// bits for the same inputs.
template <typename T>
__device__ __forceinline__ float stage_out(float res, float bias, float sum) {
  return act<T>(__fadd_rn(res, __fadd_rn(bias, sum)));
}

// Shared memory pitch of one staged row, in 4-byte words: cols pixels of
// G channels (32 bytes), padded to 24 mod 32 words so that the four rows a
// warp's (half-warp's) load touches start in distinct banks.
__host__ __device__ constexpr int row_words(int cols) {
  return cols * 8 + ((24 - (cols * 8) % 32) + 32) % 32;
}

template <typename T, int K>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int G = Traits<T>::kGroup;
  constexpr int TH = kThreads / (G / 2);
  return (K * K * G + 3 * G) * 4 + (TH + K - 1) * row_words(kR + K - 1) * 4;
}

// Stages chunk elements (16 bytes: 8 bf16 or 4 f32) from src, whose first
// n are real channels (n <= chunk), `vec` elements a load.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* src, int n, int vec, float* v,
                                           const T* base, long long extent) {
  constexpr int E = 16 / sizeof(T);
  if (vec == E && n == E) {
    TF_GUARD_SPAN(src - base, E, extent);
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = to_f32(e[i]);
    return;
  }
  if (vec == E / 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h * (E / 2) < n) {  // n is a multiple of E / 2 here
        TF_GUARD_SPAN(src + h * (E / 2) - base, E / 2, extent);
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src + h * (E / 2)));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < E / 2; ++i) v[h * (E / 2) + i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < E / 2; ++i) v[h * (E / 2) + i] = 0.0f;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    TF_GUARD_IF(i < n, src + i - base, extent);
    v[i] = i < n ? to_f32(__ldg(src + i)) : 0.0f;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) depthwise_kernel(
    const T* __restrict__ x, const T* __restrict__ wt, const T* __restrict__ bias,
    const T* __restrict__ pre_w, const T* __restrict__ pre_b, T* __restrict__ y, int h_in, int w,
    int C, int pad_top, int h_out, int tiles_x, int vec, Extents ext) {
  using Pair = typename Traits<T>::Pair;
  constexpr int G = Traits<T>::kGroup;
  constexpr int L = G / 2;               // threads across a row's channel pairs
  constexpr int TH = kThreads / L;       // output rows of a tile
  constexpr int IN_ROWS = TH + K - 1;
  constexpr int IN_COLS = kR + K - 1;
  constexpr int PITCH = row_words(IN_COLS);  // words
  constexpr int E = 16 / sizeof(T);          // elements of a 16-byte chunk
  constexpr int CHUNKS = G / E;

  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                 // [K * K][G]
  float* bs = ws + K * K * G;       // [G]
  float* pws = bs + G;              // [G]
  float* pbs = pws + G;             // [G]
  float* tile = pbs + G;            // [IN_ROWS][PITCH] words of [IN_COLS][G] T

  const int c0 = blockIdx.x * G;
  const int ty = blockIdx.y / tiles_x;
  const int row0 = ty * TH;
  const int col0 = (blockIdx.y - ty * tiles_x) * kR;
  const int b = blockIdx.z;
  const int ng = min(G, C - c0);  // real channels of this group
  const bool pre = pre_w != nullptr;

  // Weights, bias and the prologue's weights of the group's channels, f32.
  for (int t = threadIdx.x; t < K * K * G; t += kThreads) {
    const int g = t / (K * K);
    const int tap = t - g * (K * K);
    float v = 0.0f;
    if (g < ng) {
      TF_GUARD((long long)(c0 + g) * K * K + tap, ext.w);
      v = to_f32(wt[(long long)(c0 + g) * K * K + tap]);
    }
    ws[tap * G + g] = v;
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    const bool real = g < ng;
    TF_GUARD_IF(real, c0 + g, ext.bias);
    TF_GUARD_IF(real && pre, c0 + g, ext.pre_w);
    TF_GUARD_IF(real && pre, c0 + g, ext.pre_b);
    bs[g] = real ? to_f32(bias[c0 + g]) : 0.0f;
    pws[g] = real && pre ? to_f32(pre_w[c0 + g]) : 0.0f;
    pbs[g] = real && pre ? to_f32(pre_b[c0 + g]) : 0.0f;
  }
  __syncthreads();

  // The input tile and its halo: rows row0 - pad_top .. + IN_ROWS, columns
  // col0 - K/2 .. + IN_COLS, zeros outside the input.
  const T* xb = x + (long long)b * h_in * w * C;
  for (int t = threadIdx.x; t < IN_ROWS * IN_COLS * CHUNKS; t += kThreads) {
    const int chunk = t % CHUNKS;
    const int pix = t / CHUNKS;
    const int sr = pix / IN_COLS;
    const int sc = pix - sr * IN_COLS;
    const int gr = row0 - pad_top + sr;
    const int gc = col0 - K / 2 + sc;
    const int cc = chunk * E;  // channel of the group
    const int n = min(E, ng - cc);
    float v[E];
    const bool inside = gr >= 0 && gr < h_in && gc >= 0 && gc < w && n > 0;
    if (inside) {
      load_chunk<T>(xb + ((long long)gr * w + gc) * C + c0 + cc, n, vec, v, x, ext.x);
      if (pre) {
#pragma unroll
        for (int i = 0; i < E; ++i)
          v[i] = to_f32(from_f32<T>(stage_out<T>(v[i], pbs[cc + i], __fmul_rn(pws[cc + i], v[i]))));
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[i] = 0.0f;
    }
    alignas(16) T packed[E];
#pragma unroll
    for (int i = 0; i < E; ++i) packed[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(reinterpret_cast<T*>(tile + sr * PITCH) + sc * G + cc) =
        *reinterpret_cast<const uint4*>(packed);
  }
  __syncthreads();

  // The product: thread (tr, cp) owns channels 2cp, 2cp + 1 of output row
  // row0 + tr, columns col0 .. col0 + kR.
  const int cp = threadIdx.x % L;
  const int tr = threadIdx.x / L;
  const Pair* trow = reinterpret_cast<const Pair*>(tile + tr * PITCH) + cp;
  const float2* wpair = reinterpret_cast<const float2*>(ws) + cp;
  float acc0[kR], acc1[kR];
#pragma unroll
  for (int o = 0; o < kR; ++o) acc0[o] = acc1[o] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
    float w0[K], w1[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float2 wv = wpair[(i * K + j) * L];
      w0[j] = wv.x;
      w1[j] = wv.y;
    }
    const Pair* p = trow + i * (PITCH * 4 / (int)sizeof(Pair));
#pragma unroll
    for (int j = 0; j < IN_COLS; ++j) {
      const float2 v = unpack(p[j * L]);
#pragma unroll
      for (int o = 0; o < kR; ++o) {
        const int t = j - o;
        if (t >= 0 && t < K) {
          acc0[o] = fmaf(w0[t], v.x, acc0[o]);
          acc1[o] = fmaf(w1[t], v.y, acc1[o]);
        }
      }
    }
  }

  // Epilogue: bias, residual (the staged center pixel), act, one rounding.
  const int r = row0 + tr;
  if (r >= h_out) return;
  const int ch = c0 + 2 * cp;
  const float b0 = bs[2 * cp], b1 = bs[2 * cp + 1];
  const Pair* center = trow + (K / 2) * (PITCH * 4 / (int)sizeof(Pair)) + (K / 2) * L;
  T* yrow = y + (((long long)b * h_out + r) * w + col0) * C + ch;
#pragma unroll
  for (int o = 0; o < kR; ++o) {
    if (col0 + o >= w) break;
    const float2 res = unpack(center[o * L]);
    T* yo = yrow + (long long)o * C;
    if (ch < C) {
      TF_GUARD(yo - y, ext.y);
      yo[0] = from_f32<T>(stage_out<T>(res.x, b0, acc0[o]));
    }
    if (ch + 1 < C) {
      TF_GUARD(yo + 1 - y, ext.y);
      yo[1] = from_f32<T>(stage_out<T>(res.y, b1, acc1[o]));
    }
  }
}

template <typename T, int K>
int launch_k(const void* x, const void* wt, const void* bias, const void* pre_w, const void* pre_b,
             void* y, int batch, int h_in, int w, int C, int pad_top, int h_out, int vec,
             const Extents& ext, cudaStream_t s) {
  constexpr int G = Traits<T>::kGroup;
  constexpr int TH = kThreads / (G / 2);
  constexpr int smem = smem_bytes<T, K>();
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        depthwise_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int tiles_x = (w + kR - 1) / kR;
  const long long tiles = (long long)tiles_x * ((h_out + TH - 1) / TH);
  const int groups = (C + G - 1) / G;
  if (tiles > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  depthwise_kernel<T, K><<<dim3(groups, (unsigned)tiles, batch), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const T*>(bias),
      static_cast<const T*>(pre_w), static_cast<const T*>(pre_b), static_cast<T*>(y), h_in, w, C,
      pad_top, h_out, tiles_x, vec, ext);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int k, const void* x, const void* wt, const void* bias, const void* pre_w,
           const void* pre_b, void* y, int batch, int h_in, int w, int C, int pad_top, int h_out,
           int vec, const Extents& ext, cudaStream_t s) {
#define TF_DW_CASE(KK)                                                                       \
  case KK:                                                                                   \
    return launch_k<T, KK>(x, wt, bias, pre_w, pre_b, y, batch, h_in, w, C, pad_top, h_out, \
                           vec, ext, s);
  switch (k) {
    TF_DW_CASE(1)
    TF_DW_CASE(7)
    TF_DW_CASE(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TF_DW_CASE
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (x, weights, biases and y share it).
// x [batch, h_in, w, C] NHWC contiguous; wt [C, 1, k, k], k = 1, 7 or 15;
// bias [C]; pre_w [C, 1, 1, 1] and pre_b [C] (the folded k = 1 entry), both
// or neither null;
// y [batch, h_out, w, C] with h_out = h_in + pad_top + pad_bottom - (k - 1).
// vec: elements per staging load, 16 / sizeof(T), half of that, or 1; the
// caller picks the largest that C and x's alignment allow.  extents: the
// elements of x, wt, bias, pre_w, pre_b and y (read by the checked build).
// Returns the launch's cudaError_t.
extern "C" int tf_depthwise_residual_gelu(int dtype, const void* x, const void* wt,
                                          const void* bias, const void* pre_w, const void* pre_b,
                                          void* y, int batch, int h_in, int w, int C, int k,
                                          int pad_top, int pad_bottom, int vec,
                                          const long long* extents, void* stream) {
  const int h_out = h_in + pad_top + pad_bottom - (k - 1);
  const int e = dtype == 0 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || batch < 1 || h_in < 1 || w < 1 || C < 1 || pad_top < 0 ||
      pad_bottom < 0 || pad_top > k / 2 || pad_bottom > k / 2 || h_out < 1 ||
      (vec != e && vec != e / 2 && vec != 1) || bias == nullptr ||
      (pre_w == nullptr) != (pre_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const Extents ext{extents[0], extents[1], extents[2], extents[3], extents[4], extents[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(k, x, wt, bias, pre_w, pre_b, y, batch, h_in, w, C, pad_top,
                                 h_out, vec, ext, s);
  return launch<float>(k, x, wt, bias, pre_w, pre_b, y, batch, h_in, w, C, pad_top, h_out, vec,
                       ext, s);
}
