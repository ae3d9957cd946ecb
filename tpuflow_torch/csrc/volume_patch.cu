// Kernel B: exact patch of a materialized correlation volume.  One function
// serves two TPU kernels, which differ only in the volume's layout:
//   K4 `dense_patch_level` (tpuflow/kernels/denselookup.py:156, body
//      `_kernel` :49), behind DenseCorrPyramid.lookup(impl='patch'), reads a
//      query-major volume;
//   K6 `band_patch_level` (tpuflow/kernels/bandlookup.py:184, body
//      `_band_kernel` :75), behind BandCorrPyramid, reads a plane-row-outer
//      volume [B, lh, Nq, lw].
//
// What it computes, for every query n = (b, q) and clamped patch indices
// rr, cc [B, Nq, side]:
//   patch[b, q, i, j] = vol[b*sb + q*sq + rr[b,q,i]*sr + cc[b,q,j]*sc]
// a pure copy of volume entries (the strides, in elements, are arguments:
// flat [B*Nq, lh, lw] is sb = Nq*lh*lw, sq = lh*lw, sr = lw, sc = 1; the
// band layout is sb = lh*Nq*lw, sr = Nq*lw, sq = lw, sc = 1).  It equals its
// plain versions (tpuflow_torch/kernels/denselookup.py:dense_patch_level_plain,
// bandlookup.py:band_patch_level_plain) bit for bit.
//
// The TPU kernels select rows and columns with one-hot matrix products over
// grouped or banded slabs of the volume; the grouping, the lane and row
// padding and the per-block row ranges serve Mosaic's DMA and are not
// carried over.
//
// Bound on an H100: bytes (no arithmetic): side^2 entries read and written
// per query plus the indices.  Design: one thread per output entry; a
// query's side^2 threads are neighbours, so the writes of a warp are
// contiguous and its reads fall in `side` short runs of one or two lines
// each.  Offsets are 64-bit: a level-0 band volume at the 960x1080 tile
// (6 x 16 200 x 16 200 entries) is beyond 32 bits.  Every thread is guarded
// against the entry count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads) volume_patch_kernel(
    const U* __restrict__ vol, const int* __restrict__ rr, const int* __restrict__ cc,
    U* __restrict__ out, int64_t n_total, int nq, int side, int lh, int lw, int64_t sb,
    int64_t sq, int64_t sr, int64_t sc) {
  const int ss = side * side;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_total * ss) return;
  const int64_t q = t / ss;
  const int p = (int)(t - q * ss);
  const int i = p / side;
  const int j = p - i * side;
  // The caller clamps rr and cc to the plane; clamping again keeps a bad
  // index from reading outside the volume.
  const int r = min(max(rr[q * side + i], 0), lh - 1);
  const int c = min(max(cc[q * side + j], 0), lw - 1);
  const int64_t b = q / nq;
  out[t] = vol[b * sb + (q - b * nq) * sq + r * sr + c * sc];
}

}  // namespace

// elem_bytes: 2 (bf16) or 4 (f32); entries are copied, never interpreted.
// rr, cc [n_total, side] int32 with n_total = B * nq; out [n_total, side,
// side].  Returns the launch's cudaError_t.
extern "C" int tf_volume_patch(int elem_bytes, const void* vol, const int* rr, const int* cc,
                               void* out, long long n_total, int nq, int side, int lh, int lw,
                               long long sb, long long sq, long long sr, long long sc,
                               void* stream) {
  if (n_total < 1 || nq < 1 || n_total % nq != 0 || side < 1 || lh < 1 || lw < 1 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_total * side * side + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    volume_patch_kernel<uint16_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(vol), rr, cc, static_cast<uint16_t*>(out), n_total, nq,
        side, lh, lw, sb, sq, sr, sc);
  } else {
    volume_patch_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(vol), rr, cc, static_cast<uint32_t*>(out), n_total, nq,
        side, lh, lw, sb, sq, sr, sc);
  }
  return (int)cudaGetLastError();
}
