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
// The queries form a grid [Nq / grid_w, grid_w]; the caller passes its width.
//
// Bound on an H100: bytes.  One lookup of the full-frame 1080p window
// (97 200 queries, C = 256, side = 10, 4 levels) moves f1 once per level,
// each target row some patch touches once, the indices and the output:
// 224.5 MB, 0.067 ms at 3.35 TB/s.  Its 2*C*side^2 FLOP per query and level
// (19.9 GFLOP) are 0.02 ms of bf16 tensor-core time.
//
// The first design ran one warp per query and, for each of the side^2 patch
// positions, read one whole target row (512 bytes at C = 256) and took an
// FMA dot product.  That is 38.9 M row reads, 19.9 GB of L1/L2 traffic per
// lookup: at 3.06 ms it ran at the L2's rate, 45x its bound, although
// neighbouring queries' patches overlap almost completely where the flow is
// smooth.
//
// Design.  A block takes a tile of kTileH x kTileW = 4 x 8 queries of one
// image (partial tiles at the grid's edge are masked) and computes the
// union box of the tile's clamped indices, r0..r1 x c0..c1 (clamped
// repeats at the plane's border included).
// - Tensor-core path, when the box holds at most kMaxBox = 1024 pixels:
//   the tile's f1 is staged once (cp.async, in flight while the indices
//   load); the box's target pixels stream through shared memory in chunks
//   of 32 pixels x all C channels (cp.async into a ring of up to 7 slots);
//   for each chunk mma.sync m16n8k16 (bf16 in, f32 sums) gives
//   S[32, 32] = F1 U^T, which is scaled, rounded once to bf16 and kept in
//   shared memory as S[32, npix].  Then every query picks its side^2
//   entries at (rr - r0) * (c1 - c0 + 1) + (cc - c0) and writes them
//   contiguously.  S and the ring share one 96 000-byte buffer: S takes
//   what the box needs and the ring the rest, so small boxes keep more
//   chunks in flight.  kMaxBox is set by that buffer (S at the cap plus one
//   ring slot), which with f1 keeps a block at 112 KB, two blocks per SM.
//   Each target row of the box crosses L2 once per tile instead of once
//   per (query, position): about 7 pixels per query at level 0 on the
//   model's flows instead of 100.
// - Per-query path, for a tile whose box is larger (occlusion edges, large
//   independent flows): each warp takes queries of the tile in turn, reads
//   one target row per position with 16-byte loads, multiplies and adds in
//   f32 and reduces by shuffles, kGroupTile positions in flight.  The same
//   launch runs both paths; the rule depends only on rr, cc and the grid.
// - f32, and bf16 with C not a multiple of 16 or above 256 (or unaligned
//   rows), run the per-query path for every query (corr_patch_kernel):
//   TF32 would miss the f32 tolerance, and the tile's f1 must fit.
//
// What still holds it back: each tile is a chain of dependent steps
// (indices, then the box's chunks, then the products, then the stores) whose
// memory latencies dominate, and the S buffer that the cap needs allows only
// two blocks per SM to overlap them (a trial with one block per SM ran
// the same work much slower).  Deep levels have small boxes, so there the chain's
// fixed steps are most of the time, and each tile stages again pixels its
// neighbours stage too.  Tiles of large independent flows run the
// per-query loop at L2 rate as before.
//
// Bounds guards (bounds.cuh, checked build): every load of f1, rr and cc,
// every target row (its C channels, guarded once where its address is
// formed; the loads of that row read only those channels), every pixel of
// a box chunk, and every store, each against its tensor's extent.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSide = 16;          // both index vectors fit one warp
constexpr int kGroup = 4;             // patch positions reduced together
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Extents {  // elements of f1, f2, rr, cc and out (bounds guards)
  long long f1, f2, rr, cc, out;
};

// The tile kernel.
constexpr int kTileH = 4;
constexpr int kTileW = 8;
constexpr int kTileQ = kTileH * kTileW;      // 32 queries: two m16 row blocks
constexpr int kMaxBox = 1024;                // box pixels the tensor path takes
constexpr int kChunkP = 32;                  // box pixels per ring slot, all channels
constexpr int kMaxSlots = 7;                 // ring slots
constexpr int kMaxTensorC = 256;             // the tile's f1 stays staged
// S at kMaxBox and one slot at kMaxTensorC fit; two blocks fit an SM.
constexpr int kBufBytes = 96000;
static_assert(kBufBytes >= (kTileQ * (kMaxBox + 8) + kChunkP * (kMaxTensorC + 8)) * 2,
              "the union buffer holds S at the cap and one ring slot");
constexpr int kGroupTile = 8;                // positions in flight, per-query path

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

// Fold G per-lane partial sums (G positions) so that lane l ends with the
// whole sum of position l / (32 / G): each xor step halves the values a
// lane holds, then the lanes of a position sum the rest.
template <int G>
__device__ __forceinline__ float fold(float (&a)[G], int lane) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two up to 32");
#pragma unroll
  for (int n = G, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < n / 2; ++k) {
      const float keep = up ? a[k + n / 2] : a[k];
      const float send = up ? a[k] : a[k + n / 2];
      a[k] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float acc = a[0];
#pragma unroll
  for (int o = 16 / G; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  return acc;
}

// One query's whole patch by one warp (the per-query path).
// MODE > 0: the query's features in registers, C = MODE * 32 lanes * 16 bytes.
// MODE = 0: features in shared memory f1s[C], 16-byte loads of the target rows.
// MODE < 0: features in shared memory, scalar loads (rows not 16-byte multiples).
// G positions are loaded before any is reduced, so a warp keeps G row reads
// in flight.
template <typename T, int MODE, int G>
__device__ __forceinline__ void query_patch(const T* __restrict__ f1, const T* __restrict__ f2,
                                            const int* __restrict__ rr, const int* __restrict__ cc,
                                            T* __restrict__ out, int64_t q, int nq, int lh, int lw,
                                            int C, int side, float scale, float* f1s, int lane,
                                            const Extents& ext) {
  constexpr int kPer16 = 16 / (int)sizeof(T);
  float f1r[MODE > 0 ? MODE * kPer16 : 1];
  const T* f1q = f1 + q * C;
  if constexpr (MODE > 0) {
#pragma unroll
    for (int k = 0; k < MODE; ++k) {
      TF_GUARD_SPAN(f1q + (k * 32 + lane) * kPer16 - f1, kPer16, ext.f1);
#pragma unroll
      for (int t = 0; t < kPer16; ++t)
        f1r[k * kPer16 + t] = to_f32(f1q[(k * 32 + lane) * kPer16 + t]);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      TF_GUARD(f1q + c - f1, ext.f1);
      f1s[c] = to_f32(f1q[c]);
    }
  }

  // Lanes [0, side) hold the patch rows, [side, 2*side) the columns.  The
  // caller clamps them to the plane; clamping again keeps a bad index from
  // reading outside the level.
  int idx = 0;
  if (lane < side) {
    TF_GUARD(q * side + lane, ext.rr);
    idx = min(max(rr[q * side + lane], 0), lh - 1);
  } else if (lane < 2 * side) {
    TF_GUARD(q * side + lane - side, ext.cc);
    idx = min(max(cc[q * side + lane - side], 0), lw - 1);
  }
  __syncwarp();

  const T* plane = f2 + (q / nq) * ((int64_t)lh * lw * C);
  T* outq = out + q * (int64_t)(side * side);
  const int ss = side * side;
  constexpr int kLanesPer = 32 / G;
  for (int p0 = 0; p0 < ss; p0 += G) {
    float a[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int p = min(p0 + k, ss - 1);
      const int i = p / side;
      const int j = p - i * side;
      const int r = __shfl_sync(kFull, idx, i);
      const int c = __shfl_sync(kFull, idx, side + j);
      const T* row = plane + ((int64_t)r * lw + c) * C;
      TF_GUARD_SPAN(row - f2, C, ext.f2);
      if constexpr (MODE > 0) {
        a[k] = lane_dot_reg<MODE>(row, f1r, lane);
      } else {
        a[k] = lane_dot<MODE == 0>(row, f1s, C, lane);
      }
    }
    const float acc = fold<G>(a, lane);
    const int at = p0 + lane / kLanesPer;
    TF_GUARD_IF(lane % kLanesPer == 0 && at < ss, outq + at - out, ext.out);
    if (lane % kLanesPer == 0 && at < ss) store(outq + at, __fmul_rn(acc, scale));
  }
  __syncwarp();
}

// Every query by the per-query path: one warp per query, kWarps queries per
// block.  Queries are guarded, not padded.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) corr_patch_kernel(
    const T* __restrict__ f1, const T* __restrict__ f2, const int* __restrict__ rr,
    const int* __restrict__ cc, T* __restrict__ out, int64_t n_total, int nq, int lh,
    int lw, int C, int side, float scale, const Extents ext) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t q = (int64_t)blockIdx.x * kWarps + warp;
  // A whole warp leaves together and no block-wide barrier follows.
  if (q >= n_total) return;
  query_patch<T, MODE, kGroup>(f1, f2, rr, cc, out, q, nq, lh, lw, C, side, scale,
                               smem + (size_t)warp * C, threadIdx.x & 31, ext);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Wait until at most n cp.async groups are pending, n in [0, kMaxSlots).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Shared memory of the tile kernel, in bytes: the union buffer (S, then the
// pixel-chunk ring) first, so that no index into S can leave the block's
// allocation; then the tile's f1, its indices and the reduction scratch.
__host__ __device__ inline int tile_a_stride(int C) { return C + 8; }   // bf16 per f1 row
__host__ __device__ inline int tile_smem_bytes(int C) {
  return kBufBytes + kTileQ * tile_a_stride(C) * 2 + 2 * kTileQ * kMaxSide * 2 + kWarps * 4 * 4;
}

// bf16 tiles of kTileH x kTileW queries, one per block (see the header).
// MODE picks the per-query path's variant, as in corr_patch_kernel.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2) corr_patch_tile_kernel(
    const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2,
    const int* __restrict__ rr, const int* __restrict__ cc, __nv_bfloat16* __restrict__ out,
    int nq, int gw, int gh, int tiles_x, int tiles_img, int lh, int lw, int C, int side,
    float scale, const Extents ext) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  __nv_bfloat16* s_buf = reinterpret_cast<__nv_bfloat16*>(tile_smem);
  __nv_bfloat16* s_A = reinterpret_cast<__nv_bfloat16*>(tile_smem + kBufBytes);
  const int a_stride = tile_a_stride(C);
  short* s_rr = reinterpret_cast<short*>(s_A + kTileQ * a_stride);
  short* s_cc = s_rr + kTileQ * kMaxSide;
  int* s_red = reinterpret_cast<int*>(s_cc + kTileQ * kMaxSide);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / tiles_img;
  const int t = blockIdx.x - b * tiles_img;
  const int y0 = (t / tiles_x) * kTileH;
  const int x0 = (t % tiles_x) * kTileW;
  const int64_t qbase = (int64_t)b * nq;
  // Query m of the tile: grid cell (y0 + m / kTileW, x0 + m % kTileW).
  auto query = [&](int m) -> int64_t {
    const int y = y0 + m / kTileW;
    const int x = x0 + m % kTileW;
    return (y < gh && x < gw) ? qbase + (int64_t)y * gw + x : -1;
  };

  // Warp w takes the tile's queries w, w + 8, w + 16, w + 24 in every phase
  // below, so no phase divides by a runtime width per element.
  // The tile's f1, zeros for queries off the grid: one cp.async group, in
  // flight while the indices load; lane k copies 16-byte piece k (C <= 256).
  const int cpr = C / 8;
  for (int m = warp; m < kTileQ; m += kWarps) {
    const int64_t q = query(m);
    TF_GUARD_SPAN_IF(q >= 0 && lane < cpr, q * C + lane * 8, 8, ext.f1);
    if (lane < cpr)
      cp_async16(smem_u32(s_A + m * a_stride + lane * 8), q >= 0 ? f1 + q * C + lane * 8 : f1,
                 q >= 0 ? 16 : 0);
  }
  cp_async_commit();

  // The tile's clamped indices into shared memory (lanes [0, side) the
  // rows, [side, 2 side) the columns), and their union box.
  int rmin = 0x7fffffff, rmax = -1, cmin = 0x7fffffff, cmax = -1;
  for (int m = warp; m < kTileQ; m += kWarps) {
    const int64_t q = query(m);
    if (q < 0) continue;
    if (lane < side) {
      TF_GUARD(q * side + lane, ext.rr);
      const int r = min(max(rr[q * side + lane], 0), lh - 1);
      s_rr[m * kMaxSide + lane] = (short)r;
      rmin = min(rmin, r);
      rmax = max(rmax, r);
    } else if (lane < 2 * side) {
      TF_GUARD(q * side + lane - side, ext.cc);
      const int c = min(max(cc[q * side + lane - side], 0), lw - 1);
      s_cc[m * kMaxSide + lane - side] = (short)c;
      cmin = min(cmin, c);
      cmax = max(cmax, c);
    }
  }
  rmin = __reduce_min_sync(kFull, rmin);
  rmax = __reduce_max_sync(kFull, rmax);
  cmin = __reduce_min_sync(kFull, cmin);
  cmax = __reduce_max_sync(kFull, cmax);
  if (lane == 0) {
    s_red[warp * 4 + 0] = rmin;
    s_red[warp * 4 + 1] = rmax;
    s_red[warp * 4 + 2] = cmin;
    s_red[warp * 4 + 3] = cmax;
  }
  __syncthreads();
  int r0 = s_red[0], r1 = s_red[1], c0 = s_red[2], c1 = s_red[3];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    r0 = min(r0, s_red[w * 4 + 0]);
    r1 = max(r1, s_red[w * 4 + 1]);
    c0 = min(c0, s_red[w * 4 + 2]);
    c1 = max(c1, s_red[w * 4 + 3]);
  }
  const int bw = c1 - c0 + 1;
  const int npix = (r1 - r0 + 1) * bw;
  const bool tensor = npix <= kMaxBox;

  if (!tensor) {
    // The per-query path; its MODE 0 scratch is the union buffer.
    float* f1s = reinterpret_cast<float*>(s_buf) + (size_t)warp * C;
    for (int m = warp; m < kTileQ; m += kWarps) {
      const int64_t q = query(m);
      if (q >= 0)
        query_patch<__nv_bfloat16, MODE, kGroupTile>(f1, f2, rr, cc, out, q, nq, lh, lw, C, side,
                                                     scale, f1s, lane, ext);
    }
    cp_async_wait<0>();
    return;
  }

  // Each warp turns its queries' indices into offsets in the box: rows to
  // (r - r0) * bw, columns to c - c0, so S's entry is their sum.
  for (int m = warp; m < kTileQ; m += kWarps) {
    if (query(m) < 0) continue;
    if (lane < side) {
      s_rr[m * kMaxSide + lane] = (short)((s_rr[m * kMaxSide + lane] - r0) * bw);
    } else if (lane < 2 * side) {
      s_cc[m * kMaxSide + lane - side] = (short)(s_cc[m * kMaxSide + lane - side] - c0);
    }
  }

  // S [32, sstride] bf16 at the start of the buffer, sstride = 8 more than a
  // multiple of 64 (rows 16 bytes apart in the banks); the ring of pixel
  // chunks [kChunkP, C + 8] takes the rest, up to kMaxSlots slots.
  const int scols = ((min(npix, kMaxBox) + 63) / 64) * 64;
  const int sstride = scols + 8;
  const int chunk_elems = kChunkP * a_stride;
  const int npc = (npix + kChunkP - 1) / kChunkP;
  const int nslot = min(min(kMaxSlots, npc), (kBufBytes / 2 - kTileQ * sstride) / chunk_elems);
  const int ahead = nslot - 1;                  // chunks in flight while one is used
  __nv_bfloat16* s_S = s_buf;
  __nv_bfloat16* s_ring = s_buf + kTileQ * sstride;
  const __nv_bfloat16* plane = f2 + (int64_t)b * lh * lw * C;
  // Chunk j: box pixels [j * kChunkP, +kChunkP), all C channels, in slot
  // j % nslot; warp w copies pixels w, w + 8, ..., lane k piece k.
  auto load_chunk = [&](int j) {
    __nv_bfloat16* dst = s_ring + (j % nslot) * chunk_elems;
    for (int pl = warp; pl < kChunkP; pl += kWarps) {
      const int p = j * kChunkP + pl;
      const int br = p / bw;
      const __nv_bfloat16* src = plane + ((int64_t)(r0 + br) * lw + c0 + (p - br * bw)) * C;
      TF_GUARD_SPAN_IF(p < npix && lane < cpr, src + lane * 8 - f2, 8, ext.f2);
      if (lane < cpr)
        cp_async16(smem_u32(dst + pl * a_stride + lane * 8), p < npix ? src + lane * 8 : plane,
                   p < npix ? 16 : 0);
    }
  };
  for (int j = 0; j < ahead; ++j) {
    load_chunk(j);
    cp_async_commit();
  }

  // Warp w: query rows [16 (w / 4), +16) x chunk pixels [8 (w % 4), +8), one
  // m16n8 tile over all C, in two accumulators (even and odd k-steps).
  // ldmatrix lane addresses: A rows lane % 16 at channel 8 (lane / 16); B
  // pixel rows lane % 8 at channel 8 ((lane / 8) % 2).
  const int wm = (warp >> 2) * 16;
  const int wn = (warp & 3) * 8;
  const uint32_t a_addr = smem_u32(s_A + (wm + (lane & 15)) * a_stride + (lane >> 4) * 8);
  const int b_off = (wn + (lane & 7)) * a_stride + ((lane >> 3) & 1) * 8;
  for (int j = 0; j < npc; ++j) {
    if (ahead == 0) {           // one slot: load, use, release in turn
      load_chunk(j);
      cp_async_commit();
    }
    // Pending groups: f1's, then chunks up to j + ahead - 1; chunk j is in
    // once at most ahead - 1 remain.
    cp_async_wait_dyn(ahead == 0 ? 0 : ahead - 1);
    __syncthreads();            // chunk j is in; chunk j - 1's slot is free
    if (ahead > 0) {
      if (j + ahead < npc) load_chunk(j + ahead);
      cp_async_commit();
    }
    const uint32_t b_addr = smem_u32(s_ring + (j % nslot) * chunk_elems + b_off);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
    for (; k + 16 < C; k += 32) {
      uint32_t a[4], a2[4], bq[4];
      ldsm_x4(a_addr + k * 2, a);
      ldsm_x2(b_addr + k * 2, bq[0], bq[1]);
      ldsm_x4(a_addr + k * 2 + 32, a2);
      ldsm_x2(b_addr + k * 2 + 32, bq[2], bq[3]);
      mma_bf16(acc, a, bq[0], bq[1]);
      mma_bf16(acc2, a2, bq[2], bq[3]);
    }
    if (k < C) {                // C an odd number of 16-channel steps
      uint32_t a[4], bq[2];
      ldsm_x4(a_addr + k * 2, a);
      ldsm_x2(b_addr + k * 2, bq[0], bq[1]);
      mma_bf16(acc, a, bq[0], bq[1]);
    }
    // Accumulator v: row g + 8 (v / 2), column 2 t + v % 2, g = lane / 4,
    // t = lane % 4; scaled and rounded once to bf16.
    const int col = j * kChunkP + wn + 2 * (lane & 3);
    if (col < scols) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + (lane >> 2) + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(s_S + row * sstride + col) =
            __floats2bfloat162_rn(__fmul_rn(acc[2 * h] + acc2[2 * h], scale),
                                  __fmul_rn(acc[2 * h + 1] + acc2[2 * h + 1], scale));
      }
    }
    if (ahead == 0) __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Each warp writes its queries' side^2 entries contiguously, lane l
  // taking positions l, l + 32, ... (row i, column j of the patch).
  const int ss = side * side;
  unsigned short* outs = reinterpret_cast<unsigned short*>(out);
  const unsigned short* S = reinterpret_cast<const unsigned short*>(s_S);
  for (int m = warp; m < kTileQ; m += kWarps) {
    const int64_t q = query(m);
    if (q < 0) continue;
    const short* orow = s_rr + m * kMaxSide;
    const short* ocol = s_cc + m * kMaxSide;
    const unsigned short* Sm = S + m * sstride;
    unsigned short* outq = outs + q * ss;
    for (int p = lane, i = lane / side, j = lane - i * side; p < ss; p += 32) {
      TF_GUARD(outq + p - outs, ext.out);
      outq[p] = Sm[orow[i] + ocol[j]];
      j += 32;                  // the next position: 32 further in row-major order
      while (j >= side) {
        j -= side;
        ++i;
      }
    }
  }
}

template <typename T, int MODE>
int launch_mode(const void* f1, const void* f2, const int* rr, const int* cc, void* out,
                long long n_total, int nq, int lh, int lw, int C, int side, float scale,
                const Extents& ext, cudaStream_t s) {
  const long long blocks = (n_total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shared = MODE > 0 ? 0 : (size_t)kWarps * C * sizeof(float);
  if (shared > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  corr_patch_kernel<T, MODE><<<(unsigned)blocks, kThreads, shared, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), rr, cc, static_cast<T*>(out),
      n_total, nq, lh, lw, C, side, scale, ext);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_tile(const void* f1, const void* f2, const int* rr, const int* cc, void* out,
                long long n_total, int nq, int gw, int lh, int lw, int C, int side, float scale,
                const Extents& ext, cudaStream_t s) {
  const int gh = nq / gw;
  const long long tiles_x = (gw + kTileW - 1) / kTileW;
  const long long tiles_img = tiles_x * ((gh + kTileH - 1) / kTileH);
  const long long blocks = (n_total / nq) * tiles_img;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int shared = tile_smem_bytes(C);
  // The largest buffer any C needs, and room for two blocks on an SM: set
  // once per device, not on every launch (it costs host time per call).
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(corr_patch_tile_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tile_smem_bytes(kMaxTensorC));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(corr_patch_tile_kernel<MODE>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  corr_patch_tile_kernel<MODE><<<(unsigned)blocks, kThreads, shared, s>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2), rr, cc,
      static_cast<__nv_bfloat16*>(out), nq, gw, gh, (int)tiles_x, (int)tiles_img, lh, lw, C,
      side, scale, ext);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f1, const void* f2, const int* rr, const int* cc, void* out,
           long long n_total, int nq, int gw, int lh, int lw, int C, int side, float scale,
           const Extents& ext, cudaStream_t s) {
  const int per16 = 16 / (int)sizeof(T);
  const bool vec = C % per16 == 0 && reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  const int rounds = vec && C % (32 * per16) == 0 ? C / (32 * per16) : 0;
  // The tensor-core tile kernel: bf16, whole 16-channel k-steps, 16-byte
  // aligned rows of f1 and f2 for cp.async, the tile's f1 within its buffer,
  // indices that fit its 16-bit copies.
  if (sizeof(T) == 2 && vec && C % 16 == 0 && C <= kMaxTensorC &&
      reinterpret_cast<uintptr_t>(f1) % 16 == 0 && lh <= 32767 && lw <= 32767) {
    if (rounds == 1)
      return launch_tile<1>(f1, f2, rr, cc, out, n_total, nq, gw, lh, lw, C, side, scale, ext, s);
    return launch_tile<0>(f1, f2, rr, cc, out, n_total, nq, gw, lh, lw, C, side, scale, ext, s);
  }
  if (rounds == 1)
    return launch_mode<T, 1>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, ext, s);
  if (rounds == 2)
    return launch_mode<T, 2>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, ext, s);
  if (vec)
    return launch_mode<T, 0>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, ext, s);
  return launch_mode<T, -1>(f1, f2, rr, cc, out, n_total, nq, lh, lw, C, side, scale, ext, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (f1, f2 and out share it).  f1 [n_total, C] with
// n_total = B * nq, each image's nq queries a grid [nq / grid_w, grid_w];
// f2 [B, lh, lw, C]; rr, cc [n_total, side] int32; out [n_total, side, side].
// scale multiplies the f32 sum before the one rounding to dtype.  extents:
// host array of the elements of f1, f2, rr, cc and out, read by the checked
// build only.  Returns the launch's cudaError_t.
extern "C" int tf_corr_patch(int dtype, const void* f1, const void* f2, const int* rr,
                             const int* cc, void* out, long long n_total, int nq, int grid_w,
                             int lh, int lw, int C, int side, float scale,
                             const long long* extents, void* stream) {
  if (n_total < 1 || nq < 1 || n_total % nq != 0 || grid_w < 1 || nq % grid_w != 0 || lh < 1 ||
      lw < 1 || C < 1 || side < 1 || side > kMaxSide || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extents ext{extents[0], extents[1], extents[2], extents[3], extents[4]};
  if (dtype == 0)
    return launch<__nv_bfloat16>(f1, f2, rr, cc, out, n_total, nq, grid_w, lh, lw, C, side,
                                 scale, ext, s);
  return launch<float>(f1, f2, rr, cc, out, n_total, nq, grid_w, lh, lw, C, side, scale, ext, s);
}
