// K2: single-head flash attention forward, out = softmax(q k^T) v, for the
// GMA aggregation applied on every refinement iteration.
//
// Replaces the TPU kernel behind `flash_aggregate` (tpuflow/core/gma.py:35),
// which calls jax.experimental.pallas.ops.tpu.flash_attention with
// sm_scale = 1 (q arrives pre-scaled by d^-0.5, gma.py:125).  The TPU
// version pads S to its block and masks the pad with segment ids
// (gma.py:57-74); here keys >= S are masked inside the kernel and no
// padding or segment ids exist.
//
// Bound on an H100: operations.  At the 1080p tiled path (B = 6, S = 16200,
// d = 128) one call is 4*B*S^2*d = 8.1e11 FLOP, 0.82 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 75 MB of q/k/v/out traffic (0.02 ms); the
// untiled window (B = 3, S = 32400) is twice the FLOP for the same bytes.
//
// Design (bf16), the Hopper shape of a flash-attention forward:
// - One CTA per 128 query rows of one batch row: two consumer warpgroups of
//   64 rows each and one producer warp (288 threads, one CTA per SM).
// - The producer's lane 0 loads Q once and streams 128-key K and V tiles
//   with TMA into a ring of two stages in dynamic shared memory (160 KB),
//   each load completing on a `full` mbarrier; consumers hand a stage back
//   through `empty` mbarriers, K as soon as the scores are read, V once the
//   product that reads it has completed (wgmma.wait_group 0), never earlier.
// - Tensor maps are 3-D [B, S, 128] with 128-byte swizzle, boxes of 128 rows
//   x 64 columns (the swizzle's width), so a tile past S is zero-filled by
//   the TMA unit and never reads the next batch row.
// - S = Q K^T: 8 wgmma m64n128k16 per tile, A = Q and B = K from shared
//   memory, both K-major.  O += P V: 8 wgmma m64n128k16 with A = P from
//   registers (the score accumulator's layout is the A-fragment layout, so P
//   is packed to bf16 in place) and B = V from shared memory, MN-major
//   (transposed).  Accumulation in f32.
// - Online softmax in f32 registers, log2(e) folded into one FMA before
//   exp2f; O is rescaled on every tile.  Zero-filled keys would score 0, so
//   the last tile masks keys >= S to -inf; rows >= S are not stored.
// - While one warpgroup runs its softmax the other's wgmmas keep the
//   tensor cores busy; the two are not explicitly ping-ponged, and the
//   softmax of a tile does not overlap that warpgroup's own products.
//   That is what still separates it from its bound: per 128-key tile a CTA
//   has 2048 cycles of tensor-core work and 1024 of exp2 on the special
//   function units, and the two overlap only across warpgroups.
//
// The f32 entry is a plain FMA kernel (one warp per query row, exact f32
// dot products and softmax), used when the model runs in f32 — the
// CPU-vs-card parity run — and never on the bf16 main path.
//
// Bounds guards (bounds.cuh, checked build): the bf16 kernel reads Q, K and
// V only through TMA, whose tensor maps bound every box to [B, S, 128] and
// zero-fill past it, so only its O stores are guarded; the f32 kernel
// guards its loads of q, k, v and its stores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kD = 128;                            // head dim
constexpr int kBlockM = 128;                       // query rows per CTA
constexpr int kBlockN = 128;                       // keys per K/V tile
constexpr int kStages = 2;                         // K/V ring depth
constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32; // + one producer warp
constexpr int kHalfBytes = 128 * 64 * 2;           // 128 rows x 64 bf16 columns
constexpr int kTileBytes = 2 * kHalfBytes;         // 128 rows x 128 columns
constexpr int kKOff = kTileBytes;                  // Q tile first, at 0
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kBarOff = kVOff + kStages * kTileBytes;
constexpr int kSmemBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockM == kBlockN, "Q and K/V tiles share one tensor-map box");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of the 3-D map (c0 = column, c1 = row, c2 = batch row) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  sbo: bytes between
// 8-row groups; lbo: bytes between 64-column halves (read for MN-major
// operands only).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins register values at this point of the program, so that the compiler
// moves no read or write of a wgmma operand across a fence or a wait.
__device__ __forceinline__ void pin(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (+)= A B for a 64x16 A and a 16x128 B, both read from shared memory
// through descriptors, both K-major.  acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B for A 64x16 in registers (the accumulator layout of a 64x16
// slice, packed to bf16 pairs) and B 16x128 from shared memory, MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
    long long o_extent) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1 KB
  const uint32_t sq = base, sk = base + kKOff, sv = base + kVOff;
  const uint32_t bar_q = base + kBarOff;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: Q once, then K and V tile by tile into the ring.  A stage's
    // first use waits on parity 1, which a fresh barrier reports complete.
    if (lane == 0) {
      mbar_expect_tx(bar_q, kTileBytes);
      tma_load(sq, &tq, bar_q, 0, q0, b);
      tma_load(sq + kHalfBytes, &tq, bar_q, 64, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        const uint32_t kdst = sk + st * kTileBytes, vdst = sv + st * kTileBytes;
        mbar_wait(empty_k + 8 * st, parity);
        mbar_expect_tx(full_k + 8 * st, kTileBytes);
        tma_load(kdst, &tk, full_k + 8 * st, 0, j * kBlockN, b);
        tma_load(kdst + kHalfBytes, &tk, full_k + 8 * st, 64, j * kBlockN, b);
        mbar_wait(empty_v + 8 * st, parity);
        mbar_expect_tx(full_v + 8 * st, kTileBytes);
        tma_load(vdst, &tv, full_v + 8 * st, 0, j * kBlockN, b);
        tma_load(vdst + kHalfBytes, &tv, full_v + 8 * st, 64, j * kBlockN, b);
      }
    }
    return;
  }

  // Consumers.  Accumulator entry i of a thread lies in row
  // 16*wl + g + 8*((i >> 1) & 1) of the warpgroup's 64 and column
  // 8*(i >> 2) + 2*tg + (i & 1) of the 128.
  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's rows in each half of Q

  float oacc[64], sacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = sacc[i] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max of rows g, g + 8
  float l0 = 0.0f, l1 = 0.0f;                    // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t kt = sk + st * kTileBytes, vt = sv + st * kTileBytes;

    mbar_wait(full_k + 8 * st, parity);
    pin(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
      wgmma_ss(sacc, smem_desc(qa + off, 16, 1024), smem_desc(kt + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k + 8 * st);

    if ((j + 1) * kBlockN > S) {
      const int valid = S - j * kBlockN;  // zero-filled keys past S score 0: mask them
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (8 * (i >> 2) + 2 * tg + (i & 1) >= valid) sacc[i] = -CUDART_INF_F;
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sacc[i], sacc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[i + 2], sacc[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds a key < S, so the max is finite from the first tile
    // on and exp2(-inf) = 0 rescales the empty initial state.
    const float a0 = exp2f((m0 - mx0) * kLog2e);
    const float a1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      oacc[i] *= (i & 2) ? a1 : a0;
    }

    // P = exp(S - max), packed to bf16 in place as the A fragments of the
    // 8 k-steps of 16 keys (n-tiles 2kk and 2kk + 1 of the scores).
    const float nb0 = -mx0 * kLog2e, nb1 = -mx1 * kLog2e;
    uint32_t pf[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (2 * kk + h) * 4;
        const float p0 = exp2f(fmaf(sacc[i], kLog2e, nb0));
        const float p1 = exp2f(fmaf(sacc[i + 1], kLog2e, nb0));
        const float p2 = exp2f(fmaf(sacc[i + 2], kLog2e, nb1));
        const float p3 = exp2f(fmaf(sacc[i + 3], kLog2e, nb1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[kk][2 * h] = pack_f32(p0, p1);
        pf[kk][2 * h + 1] = pack_f32(p2, p3);
      }
    }

    mbar_wait(full_v + 8 * st, parity);
    pin(oacc);
    pin(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_rs(oacc, pf[kk], smem_desc(vt + kk * 16 * 128, kHalfBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(oacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v + 8 * st);  // only now may the next TMA overwrite V
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0;
  const float inv1 = 1.0f / l1;
  const int r0 = q0 + wg * 64 + wl * 16 + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)b * S * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = n * 8 + tg * 2;
    TF_GUARD_IF(r0 < S, ob + (size_t)r0 * kD + c + 1 - o, o_extent);
    TF_GUARD_IF(r1 < S, ob + (size_t)r1 * kD + c + 1 - o, o_extent);
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kD + c) =
          pack_f32(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kD + c) =
          pack_f32(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
  }
}

constexpr int kF32Warps = 4;

struct Extents {  // elements of q, k, v and o (bounds guards)
  long long q, k, v, o;
};

// One warp per query row; lane i holds head dims 4i..4i+3.
__global__ void __launch_bounds__(32 * kF32Warps) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, long long rows,
    const Extents extent) {
  const long long row = (long long)blockIdx.x * kF32Warps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)(row / S) * S * kD;
  TF_GUARD_SPAN((size_t)row * kD + 4 * lane, 4, extent.q);
  const float4 qv = reinterpret_cast<const float4*>(q + (size_t)row * kD)[lane];
  float m = -CUDART_INF_F, l = 0.0f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < S; ++j) {
    TF_GUARD_SPAN(base + (size_t)j * kD + 4 * lane, 4, extent.k);
    TF_GUARD_SPAN(base + (size_t)j * kD + 4 * lane, 4, extent.v);
    const float4 kv = reinterpret_cast<const float4*>(k + base + (size_t)j * kD)[lane];
    float s = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, s);
    const float a = expf(m - mn);
    const float p = expf(s - mn);
    const float4 vv = reinterpret_cast<const float4*>(v + base + (size_t)j * kD)[lane];
    l = l * a + p;
    acc.x = acc.x * a + p * vv.x;
    acc.y = acc.y * a + p * vv.y;
    acc.z = acc.z * a + p * vv.z;
    acc.w = acc.w * a + p * vv.w;
    m = mn;
  }
  const float inv = 1.0f / l;
  TF_GUARD_SPAN((size_t)row * kD + 4 * lane, 4, extent.o);
  reinterpret_cast<float4*>(o + (size_t)row * kD)[lane] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

}  // namespace

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no link against libcuda.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// [B, S, 128] bf16, row pitch 256 B, as a 3-D map (columns, rows, batch
// rows) with 128-row x 64-column boxes and 128-byte swizzle.  Boxes past S
// are zero-filled.
static bool qkv_map(CUtensorMap* map, const void* ptr, int B, int S) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)S * kD * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kBlockN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, k, v, o: [B, S, 128] contiguous, 16-byte aligned.  dtype: 0 = bf16,
// 1 = f32.  extents: host array of the elements of q, k, v and o, read by
// the checked build only.  Returns the launch's cudaError_t.
extern "C" int tf_flash_attention_fwd(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      const long long* extents, void* stream) {
  if (B < 1 || S < 1 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    CUtensorMap tq, tk, tv;
    if (!qkv_map(&tq, q, B, S) || !qkv_map(&tk, k, B, S) || !qkv_map(&tv, v, B, S))
      return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
      const cudaError_t rc = cudaFuncSetAttribute(
          flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (rc != cudaSuccess) return (int)rc;
      configured = true;
    }
    const dim3 grid((unsigned)((S + kBlockM - 1) / kBlockM), (unsigned)B);
    flash_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, extents[3]);
  } else {
    const long long rows = (long long)B * S;
    const unsigned blocks = (unsigned)((rows + kF32Warps - 1) / kF32Warps);
    flash_fwd_f32_kernel<<<blocks, 32 * kF32Warps, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, rows,
        Extents{extents[0], extents[1], extents[2], extents[3]});
  }
  return (int)cudaGetLastError();
}
