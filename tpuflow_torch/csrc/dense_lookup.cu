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
// only the levels from k on (the dense sidecar of FlashCorr).  This is the
// fused TPU kernel's two-stage f32 bilinear.  The plain version is
// tpuflow_torch/kernels/denselookup.py:dense_lookup_plain; the rounding
// steps are explicit (__fmul_rn/__fadd_rn) so the kernel does not contract
// them into FMAs and agrees with it bit for bit.
//
// Bound on an H100: bytes.  At the 1080p tiled path (N = 6 x 16200
// queries, 4 levels, r = 4) one call writes 126 MB of f32 output and needs
// at most 78 MB of bf16 taps, against ~0.3 GFLOP of arithmetic.  The TPU
// kernel streamed the whole volume through one-hot matmuls because its
// gather was slow; a GPU gathers natively, so this kernel reads only taps.
//
// Design: one warp per query, 8 queries per block.
// - The query's pixel and its base coordinates (x + fx, y + fy) are read and
//   computed once for all levels, in 32-bit integers; 64-bit arithmetic is
//   used only for the offset of the query's plane.
// - Each tap of a level's (2r+2)^2 patch is read once: lane = (row in pass,
//   column), so consecutive lanes read consecutive addresses along a patch
//   row (2r+2 values, 20 bytes at r = 4) and a warp covers 32 / (2r+2) rows
//   per pass.  Taps outside the plane become 0 without a load.  The taps go
//   to the warp's slice of shared memory, column-major.
// - The (2r+1)^2 outputs of each level come out of the staged taps in the
//   order above, and a query's L (2r+1)^2 outputs (1296 bytes at the tiled
//   path) are written by consecutive lanes to consecutive addresses.
// One patch row must fit in a warp and the staged patches of a block in
// shared memory, so r <= 14 (the wrapper raises above that).
// In the checked build (bounds.cuh) every load of the flow and of a level
// and every store of the output is guarded against that tensor's extent,
// each level against its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 14;
constexpr int kWarps = 8;  // queries per block

struct Levels {
  const void* vol[kMaxLevels];
  int lh[kMaxLevels];
  int lw[kMaxLevels];
  long long extent[kMaxLevels];  // elements of each level's tensor (bounds guards)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(w, __fsub_rn(b, a)));
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) dense_lookup_kernel(
    const __grid_constant__ Levels levels, const float* __restrict__ flow,
    float* __restrict__ out, int n_query, int h, int w, int radius, int n_levels,
    int level_offset, long long flow_extent, long long out_extent) {
  extern __shared__ float staged[];  // per warp: n_levels patches, [column][row]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= n_query) return;  // the whole warp

  const int side = 2 * radius + 2;
  const int ns = side - 1;
  const int ncs = ns * ns;
  const int patch = side * side;
  float* taps = staged + warp * n_levels * patch;

  const int pix = q % (h * w);
  const int y = pix / w;
  const int x = pix - y * w;
  TF_GUARD_SPAN(2 * (int64_t)q, 2, flow_extent);
  const float bx = __fadd_rn((float)x, flow[2 * (int64_t)q]);
  const float by = __fadd_rn((float)y, flow[2 * (int64_t)q + 1]);

  // This lane's place in a pass over the patch: `rows` whole rows per pass.
  const int rows = 32 / side;
  const int sub = lane / side;
  const int col = lane - sub * side;
  const bool loader = sub < rows;
  const int passes = (side + rows - 1) / rows;

  for (int l = 0; l < n_levels; ++l) {
    const float scale = 1.0f / (float)(1 << (l + level_offset));  // exact: a power of two
    const int x0 = (int)floorf(__fmul_rn(bx, scale)) - radius;
    const int y0 = (int)floorf(__fmul_rn(by, scale)) - radius;
    const int lh = levels.lh[l];
    const int lw = levels.lw[l];
    const T* pl = static_cast<const T*>(levels.vol[l]) + (int64_t)q * ((int64_t)lh * lw);
    float* tl = taps + l * patch;
    const int gc = x0 + col;
    for (int p0 = 0; p0 < passes; p0 += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = (p0 + u) * rows + sub;
        const int gr = y0 + row;
        const bool inside = gr >= 0 && gr < lh && gc >= 0 && gc < lw;
        v[u] = 0.0f;
        if (loader && row < side) {
          TF_GUARD_IF(inside, pl + gr * lw + gc - static_cast<const T*>(levels.vol[l]),
                      levels.extent[l]);
          v[u] = inside ? to_f32(__ldg(pl + gr * lw + gc)) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = (p0 + u) * rows + sub;
        if (loader && row < side) tl[col * side + row] = v[u];
      }
    }
  }
  __syncwarp();

  float* o = out + (int64_t)q * (n_levels * ncs);
  for (int l = 0; l < n_levels; ++l) {
    const float scale = 1.0f / (float)(1 << (l + level_offset));
    const float cx = __fmul_rn(bx, scale);
    const float cy = __fmul_rn(by, scale);
    const float wx = __fsub_rn(cx, floorf(cx));
    const float wy = __fsub_rn(cy, floorf(cy));
    const float* tl = taps + l * patch;
    for (int c = lane; c < ncs; c += 32) {
      const int j = c / ns;      // column (x) offset within the window
      const int i = c - j * ns;  // row (y) offset
      const float* p = tl + j * side + i;
      const float t0 = lerp_rn(p[0], p[side], wx);      // row i, columns j -> j+1
      const float t1 = lerp_rn(p[1], p[side + 1], wx);  // row i+1
      TF_GUARD(o + l * ncs + c - out, out_extent);
      o[l * ncs + c] = lerp_rn(t0, t1, wy);
    }
  }
}

template <typename T>
int launch(const Levels& levels, const float* flow, float* out, int n_query, int h, int w,
           int radius, int n_levels, int level_offset, long long flow_extent,
           long long out_extent, cudaStream_t s) {
  const int side = 2 * radius + 2;
  const int smem = kWarps * n_levels * side * side * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dense_lookup_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const unsigned blocks = (unsigned)((n_query + kWarps - 1) / kWarps);
  dense_lookup_kernel<T><<<blocks, 32 * kWarps, smem, s>>>(
      levels, flow, out, n_query, h, w, radius, n_levels, level_offset, flow_extent, out_extent);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16 volumes, 1 = f32 volumes.  vols/lh/lw/extents: host
// arrays of n_levels entries, extents the elements of each level's tensor.
// flow: [n_query, 2] f32 of flow_extent elements; out: [n_query, n_levels *
// (2r+1)^2] f32 of out_extent.  Stored level l is sampled at scale
// 2^(l + level_offset).  The extents are read by the checked build only.
// Returns the launch's cudaError_t.
extern "C" int tf_dense_lookup(int dtype, const void* const* vols, const int* lh,
                               const int* lw, const long long* extents, int n_levels,
                               const float* flow, long long flow_extent, float* out,
                               long long out_extent, long long n_query, int h, int w,
                               int radius, int level_offset, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_query < 1 || n_query > INT_MAX || h < 1 ||
      w < 1 || (long long)h * w > INT_MAX || radius < 0 || radius > kMaxRadius ||
      level_offset < 0 || level_offset + n_levels > 30 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels levels;
  for (int l = 0; l < n_levels; ++l) {
    levels.vol[l] = vols[l];
    levels.lh[l] = lh[l];
    levels.lw[l] = lw[l];
    levels.extent[l] = extents[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(levels, flow, out, (int)n_query, h, w, radius, n_levels,
                                 level_offset, flow_extent, out_extent, s);
  return launch<float>(levels, flow, out, (int)n_query, h, w, radius, n_levels, level_offset,
                       flow_extent, out_extent, s);
}
