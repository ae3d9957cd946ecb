// K1: fused dense radius lookup over a materialized correlation pyramid.
//
// Replaces the TPU kernel `dense_feature_level` (tpuflow/kernels/
// denselookup.py:398, body `_fused_kernel` :258), which DenseCorrPyramid
// .lookup (tpuflow/core/corr.py:597-606, _lookup_kernel :704-786) runs once
// per level and direction on every refinement iteration.
//
// What it computes, for every query n = (b, y, x) and stored level l with
// flat volume V_l [N, lh, lw] (bf16 or f32), flow (fx, fy) and radius r:
//   cx = (x + fx) / 2^(l+o), x0 = floor(cx), wx = cx - x0   (same for y)
//   p[j][i] = V_l[n, y0 - r + i, x0 - r + j], 0 outside [0,lh) x [0,lw)
//   t       = p[j][i] + wx * (p[j+1][i] - p[j][i])         (f32)
//   s       = t[j][i] + wy * (t[j][i+1] - t[j][i])         (f32)
//   out[n, l*(2r+1)^2 + j*(2r+1) + i] = s                  (x-major order)
// where o = level_offset is 0 for a whole pyramid and k for one that holds
// only the levels from k on (the dense sidecar of FlashCorr).
// which is the fused TPU kernel's two-stage f32 bilinear.  The plain
// version is tpuflow_torch/kernels/denselookup.py:dense_lookup_plain; the
// rounding steps are explicit (__fmul_rn/__fadd_rn) so the kernel does
// not contract them into FMAs and agrees with it bit for bit.
//
// Bound on an H100: bytes.  Per level-call at the 1080p main path (N =
// 6 x 16200 queries) the f32 output is 31.5 MB and the (2r+2)^2 patch taps
// are 19.4 MB of bf16 — against ~0.1 GFLOP of arithmetic.  The TPU kernel
// streamed the whole volume through one-hot matmuls because its gather
// was slow; a GPU gathers natively, so this kernel reads only the taps.
//
// Design: one thread per (query, output tap) with a grid row per level, so
// one launch covers every level.  Neighbouring threads are neighbouring
// taps of one query: the 4 reads of a tap hit the same or adjacent lines as
// its neighbours' (L1 reuse), and the writes of a warp are contiguous.
// Every index is guarded against N (N = 97200 is a multiple of no power of
// two block) and out-of-plane taps read 0 without touching memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  const void* vol[kMaxLevels];
  int lh[kMaxLevels];
  int lw[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float tap(const T* __restrict__ plane, int row, int col,
                                     int lh, int lw) {
  if (row < 0 || row >= lh || col < 0 || col >= lw) return 0.0f;
  return to_f32(plane[(int64_t)row * lw + col]);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(w, __fsub_rn(b, a)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dense_lookup_kernel(
    Levels levels, const float* __restrict__ flow, float* __restrict__ out,
    int64_t n_query, int h, int w, int radius, int n_levels, int level_offset) {
  const int ns = 2 * radius + 1;
  const int ncs = ns * ns;
  const int lvl = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_query * ncs) return;
  const int64_t q = t / ncs;
  const int c = (int)(t - q * ncs);
  const int j = c / ns;        // column (x) offset within the window
  const int i = c - j * ns;    // row (y) offset within the window

  const int pix = (int)(q % ((int64_t)h * w));
  const int y = pix / w;
  const int x = pix - y * w;
  const float scale = 1.0f / (float)(1 << (lvl + level_offset));  // exact: a power of two
  const float cx = __fmul_rn(__fadd_rn((float)x, flow[2 * q]), scale);
  const float cy = __fmul_rn(__fadd_rn((float)y, flow[2 * q + 1]), scale);
  const float x0 = floorf(cx);
  const float y0 = floorf(cy);
  const float wx = __fsub_rn(cx, x0);
  const float wy = __fsub_rn(cy, y0);
  const int col = (int)x0 - radius + j;
  const int row = (int)y0 - radius + i;

  const int lh = levels.lh[lvl];
  const int lw = levels.lw[lvl];
  const T* plane = static_cast<const T*>(levels.vol[lvl]) + q * ((int64_t)lh * lw);
  const float p00 = tap(plane, row, col, lh, lw);
  const float p10 = tap(plane, row, col + 1, lh, lw);
  const float p01 = tap(plane, row + 1, col, lh, lw);
  const float p11 = tap(plane, row + 1, col + 1, lh, lw);
  const float t0 = lerp_rn(p00, p10, wx);   // row i, columns j -> j+1
  const float t1 = lerp_rn(p01, p11, wx);   // row i+1
  out[q * ((int64_t)n_levels * ncs) + (int64_t)lvl * ncs + c] = lerp_rn(t0, t1, wy);
}

}  // namespace

// dtype: 0 = bf16 volumes, 1 = f32 volumes.  vols/lh/lw: host arrays of
// n_levels entries.  flow: [n_query, 2] f32; out: [n_query, n_levels *
// (2r+1)^2] f32.  Stored level l is sampled at scale 2^(l + level_offset).
// Returns the launch's cudaError_t.
extern "C" int tf_dense_lookup(int dtype, const void* const* vols, const int* lh,
                               const int* lw, int n_levels, const float* flow,
                               float* out, long long n_query, int h, int w,
                               int radius, int level_offset, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_query < 1 || h < 1 || w < 1 ||
      radius < 0 || level_offset < 0 || level_offset + n_levels > 30 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels levels;
  for (int l = 0; l < n_levels; ++l) {
    levels.vol[l] = vols[l];
    levels.lh[l] = lh[l];
    levels.lw[l] = lw[l];
  }
  const long long ncs = (long long)(2 * radius + 1) * (2 * radius + 1);
  const long long blocks = (n_query * ncs + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dense_lookup_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        levels, flow, out, n_query, h, w, radius, n_levels, level_offset);
  } else {
    dense_lookup_kernel<float><<<grid, kThreads, 0, s>>>(
        levels, flow, out, n_query, h, w, radius, n_levels, level_offset);
  }
  return (int)cudaGetLastError();
}
