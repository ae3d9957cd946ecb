// Kernel A: recomputed correlation patch.  One function serves two TPU
// kernels, which differ only in how Mosaic wants the pooled target features
// stored:
//   K3 `flash2_patch_level` (tpuflow/kernels/flashcorr2.py:246, body
//      `_kernel` :146, phase-packed rows, chunk gating), behind FlashCorr2;
//   K5 `flash_patch_level` (tpuflow/kernels/flashcorr.py:157, body `_kernel`
//      :88, lane-padded rows), behind FlashCorr.
//
// What it computes, for every query n = (b, q), one pyramid level of pooled
// target features F2 [B, lh, lw, C] (unpacked, unpadded), query features
// F1 [B, Nq, C] and clamped patch indices rr, cc [B, Nq, side]:
//   patch[b, q, i, j] = cast( (sum_c F1[b,q,c] * F2[b, rr[b,q,i], cc[b,q,j], c])
//                             * (1/sqrt(C)) )
// with the sum in f32 and one rounding to the storage type, which is what a
// materialized volume holds at that entry (flashcorr2.py:165-169).  The plain
// version is tpuflow_torch/kernels/flashcorr2.py:flash2_patch_level_plain.
//
// The TPU kernels compute whole correlation rows against chunks of the
// target plane on the matrix unit and pick the patch out with one-hot
// products, because a TPU gathers slowly; packing, padding, phase masks, the
// fetch table and query padding all serve that.  A GPU gathers natively, so
// this kernel computes only the side^2 dots a patch needs.
//
// Bound on an H100: bytes.  One lookup of the full-frame 1080p window
// (97 200 queries, C = 256, side = 10, 4 levels) needs 2*C*side^2 FLOP per
// query and level (19.9 GFLOP, 0.02 ms of bf16 tensor-core time) against
// about 0.2 GB of f1, touched f2 rows, indices and output (0.06 ms).
//
// Design: a simple kernel that is right.  One warp per query, 8 consecutive
// queries per block (their patches overlap where the flow is smooth, so L1
// serves most rows).  For each patch position the warp's 32 lanes read one
// contiguous target row with 16-byte loads, multiply-add in f32 and reduce
// by shuffles, four positions at a time.  The query's features stay in
// registers where C is one or two rounds of 32 lanes x 16 bytes (C = 256 in
// both dtypes), else as f32 in shared memory.  The arithmetic runs on the
// FMA units, not the tensor cores, and each target row is fetched from L1/L2
// once per (query, position).  Queries are guarded, not padded (97 200 and
// 32 400 divide by no power of two); C is a runtime argument (scalar loads
// when rows are not 16-byte multiples).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSide = 16;          // both index vectors fit one warp
constexpr int kGroup = 4;             // patch positions reduced together
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// This lane's share of dot(row, f1s): every 32nd 16-byte group of the row.
template <bool VEC>
__device__ __forceinline__ float lane_dot(const float* __restrict__ row,
                                          const float* __restrict__ f1s, int C, int lane) {
  float acc = 0.0f;
  if (VEC) {
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + c));
      const float4 a = *reinterpret_cast<const float4*>(f1s + c);
      acc = fmaf(v.x, a.x, acc);
      acc = fmaf(v.y, a.y, acc);
      acc = fmaf(v.z, a.z, acc);
      acc = fmaf(v.w, a.w, acc);
    }
  } else {
    for (int c = lane; c < C; c += 32) acc = fmaf(__ldg(row + c), f1s[c], acc);
  }
  return acc;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <bool VEC>
__device__ __forceinline__ float lane_dot(const __nv_bfloat16* __restrict__ row,
                                          const float* __restrict__ f1s, int C, int lane) {
  float acc = 0.0f;
  if (VEC) {
    for (int c = lane * 8; c < C; c += 256) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c));
      const float4 a = *reinterpret_cast<const float4*>(f1s + c);
      const float4 b = *reinterpret_cast<const float4*>(f1s + c + 4);
      acc = fmaf(bf16_lo(v.x), a.x, acc);
      acc = fmaf(bf16_hi(v.x), a.y, acc);
      acc = fmaf(bf16_lo(v.y), a.z, acc);
      acc = fmaf(bf16_hi(v.y), a.w, acc);
      acc = fmaf(bf16_lo(v.z), b.x, acc);
      acc = fmaf(bf16_hi(v.z), b.y, acc);
      acc = fmaf(bf16_lo(v.w), b.z, acc);
      acc = fmaf(bf16_hi(v.w), b.w, acc);
    }
  } else {
    for (int c = lane; c < C; c += 32) acc = fmaf(to_f32(row[c]), f1s[c], acc);
  }
  return acc;
}

// The same share with the query's features in registers: when C is NCH
// whole rounds of 32 lanes x 16 bytes, a lane always meets the same NCH
// 16-byte groups of a row, so it keeps just those features, f[], for the
// whole patch and shared memory is not read at all.
template <int NCH>
__device__ __forceinline__ float lane_dot_reg(const float* __restrict__ row,
                                              const float (&f)[NCH * 4], int lane) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + k * 128 + lane * 4));
    acc = fmaf(v.x, f[4 * k + 0], acc);
    acc = fmaf(v.y, f[4 * k + 1], acc);
    acc = fmaf(v.z, f[4 * k + 2], acc);
    acc = fmaf(v.w, f[4 * k + 3], acc);
  }
  return acc;
}

template <int NCH>
__device__ __forceinline__ float lane_dot_reg(const __nv_bfloat16* __restrict__ row,
                                              const float (&f)[NCH * 8], int lane) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k * 256 + lane * 8));
    acc = fmaf(bf16_lo(v.x), f[8 * k + 0], acc);
    acc = fmaf(bf16_hi(v.x), f[8 * k + 1], acc);
    acc = fmaf(bf16_lo(v.y), f[8 * k + 2], acc);
    acc = fmaf(bf16_hi(v.y), f[8 * k + 3], acc);
    acc = fmaf(bf16_lo(v.z), f[8 * k + 4], acc);
    acc = fmaf(bf16_hi(v.z), f[8 * k + 5], acc);
    acc = fmaf(bf16_lo(v.w), f[8 * k + 6], acc);
    acc = fmaf(bf16_hi(v.w), f[8 * k + 7], acc);
  }
  return acc;
}

// MODE > 0: the query's features in registers, C = MODE * 32 lanes * 16 bytes.
// MODE = 0: features in shared memory, 16-byte loads of the target rows.
// MODE < 0: features in shared memory, scalar loads (rows not 16-byte multiples).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) corr_patch_kernel(
    const T* __restrict__ f1, const T* __restrict__ f2, const int* __restrict__ rr,
    const int* __restrict__ cc, T* __restrict__ out, int64_t n_total, int nq, int lh,
    int lw, int C, int side, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kWarps + warp;
  // A whole warp leaves together and no block-wide barrier follows.
  if (q >= n_total) return;

  constexpr int kPer16 = 16 / (int)sizeof(T);
  float f1r[MODE > 0 ? MODE * kPer16 : 1];
  float* f1s = smem + (size_t)warp * C;
  const T* f1q = f1 + q * C;
  if constexpr (MODE > 0) {
#pragma unroll
    for (int k = 0; k < MODE; ++k)
#pragma unroll
      for (int t = 0; t < kPer16; ++t)
        f1r[k * kPer16 + t] = to_f32(f1q[(k * 32 + lane) * kPer16 + t]);
  } else {
    for (int c = lane; c < C; c += 32) f1s[c] = to_f32(f1q[c]);
  }

  // Lanes [0, side) hold the patch rows, [side, 2*side) the columns.  The
  // caller clamps them to the plane; clamping again keeps a bad index from
  // reading outside the level.
  int idx = 0;
  if (lane < side) {
    idx = min(max(rr[q * side + lane], 0), lh - 1);
  } else if (lane < 2 * side) {
    idx = min(max(cc[q * side + lane - side], 0), lw - 1);
  }
  __syncwarp();

  const T* plane = f2 + (q / nq) * ((int64_t)lh * lw * C);
  T* outq = out + q * (int64_t)(side * side);
  const int ss = side * side;
  // kGroup positions at a time: their kGroup target rows are loaded before
  // any is reduced, so a warp keeps several loads in flight, and the
  // reduction folds the kGroup partial sums together (6 shuffles for 4 dots
  // instead of 20).  side = 2r+2 is even, so kGroup = 4 divides side^2; the
  // guard covers any other side.
  for (int p0 = 0; p0 < ss; p0 += kGroup) {
    float a[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int p = min(p0 + k, ss - 1);
      const int i = p / side;
      const int j = p - i * side;
      const int r = __shfl_sync(kFull, idx, i);
      const int c = __shfl_sync(kFull, idx, side + j);
      const T* row = plane + ((int64_t)r * lw + c) * C;
      if constexpr (MODE > 0) {
        a[k] = lane_dot_reg<MODE>(row, f1r, lane);
      } else {
        a[k] = lane_dot<MODE == 0>(row, f1s, C, lane);
      }
    }
    // Fold: after the xor-16 step lanes 0-15 hold positions 0 and 1 and lanes
    // 16-31 positions 2 and 3; after the xor-8 step each run of 8 lanes holds
    // one position, k = lane / 8, which three more steps sum.
    static_assert(kGroup == 4, "the fold below is written for four positions");
    const bool up16 = lane & 16;
    float k0 = (up16 ? a[2] : a[0]) + __shfl_xor_sync(kFull, up16 ? a[0] : a[2], 16);
    float k1 = (up16 ? a[3] : a[1]) + __shfl_xor_sync(kFull, up16 ? a[1] : a[3], 16);
    const bool up8 = lane & 8;
    float acc = (up8 ? k1 : k0) + __shfl_xor_sync(kFull, up8 ? k0 : k1, 8);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    const int at = p0 + (lane >> 3);
    if ((lane & 7) == 0 && at < ss) store(outq + at, __fmul_rn(acc, scale));
  }
}

template <typename T, int MODE>
int launch_mode(const void* f1, const void* f2, const int* rr, const int* cc, void* out,
                long long n_total, int nq, int lh, int lw, int C, int side, float scale,
                cudaStream_t s) {
  const long long blocks = (n_total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shared = MODE > 0 ? 0 : (size_t)kWarps * C * sizeof(float);
  if (shared > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  corr_patch_kernel<T, MODE><<<(unsigned)blocks, kThreads, shared, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), rr, cc, static_cast<T*>(out),
      n_total, nq, lh, lw, C, side, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f1, const void* f2, const int* rr, const int* cc, void* out,
           long long n_total, int nq, int lh, int lw, int C, int side, float scale,
           cudaStream_t s) {
  const int per16 = 16 / (int)sizeof(T);
  const bool vec = C % per16 == 0 && reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  const int rounds = vec && C % (32 * per16) == 0 ? C / (32 * per16) : 0;
  if (rounds == 1)
    return launch_mode<T, 1>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, s);
  if (rounds == 2)
    return launch_mode<T, 2>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, s);
  if (vec)
    return launch_mode<T, 0>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, s);
  return launch_mode<T, -1>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (f1, f2 and out share it).  f1 [n_total, C] with
// n_total = B * nq; f2 [B, lh, lw, C]; rr, cc [n_total, side] int32; out
// [n_total, side, side].  scale multiplies the f32 sum before the one
// rounding to dtype.  Returns the launch's cudaError_t.
extern "C" int tf_corr_patch(int dtype, const void* f1, const void* f2, const int* rr,
                             const int* cc, void* out, long long n_total, int nq, int lh,
                             int lw, int C, int side, float scale, void* stream) {
  if (n_total < 1 || nq < 1 || n_total % nq != 0 || lh < 1 || lw < 1 || C < 1 || side < 1 ||
      side > kMaxSide || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, s);
  return launch<float>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, s);
}
