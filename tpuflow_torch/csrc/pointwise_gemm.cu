// K8: one 1x1 convolution of PCBlock4 (core/sk.py) as a GEMM on NHWC
// tensors as they are stored, with its bias, residual add and activation in
// the epilogue:
//   y[m, n] = act(res[m, n] + (bias[n] + sum_k x[m, k] * W[n, k]))
// for x [M, K] (M tokens, rows lda elements apart), W [N, K] (the conv's
// weight [N, K, 1, 1], K-major), bias [N], an optional res [M, N] (rows ldr
// apart) and y [M, N] (rows ldy apart).  act is the identity or GELU, the tanh
// form in bf16 and the erf form in f32 (core/encoders.gelu), evaluated on
// the f32 sum; the sums are f32 and y is rounded once to x's dtype.  The
// plain version is tpuflow_torch/kernels/pointwise.py:pointwise_gemm_plain.
//
// It replaces no TPU kernel: the JAX package left these convolutions to
// XLA (tpuflow/core/sk.py, PCBlock4_Deep_nopool_res), which fuses the add
// and the activation into the product's epilogue.  It was added because on
// an H100 cuDNN ran them on NCHW views of NHWC tensors, and every
// activation went through memory two or three more times: the add (as a
// strided elementwise kernel), the GELU, and cuDNN's padding of channel
// counts that are not multiples of 8 (324, 486, 972).
//
// Bound on an H100: bytes, for most of PCBlock4's widths.  A token reads K
// and writes N bf16 values, and reads N more with a residual, against 2 K N
// operations: 2 K N / (2 (K + 2 N)) = 150-390 operations a byte at the
// widths PCBlock4 uses (K, N in 128..972), about the card's ridge point
// (989 TFLOP/s over 3.35 TB/s, 295).  At VideoFlow MOF's 1080p tile path
// (97 200 tokens, 12 iterations, six PCBlocks of five convolutions each) one
// pass over every input, output and residual is about 68 GB a frame (20 ms),
// the products about 13.3 TFLOP (13.5 ms).  Behind device memory, the L2
// cache bounds the wide ones: every tile reads its rows of x and its
// columns of W from L2, so that traffic grows as 1 / BM + 1 / BN.
//
// Design (bf16), what it does about those bounds: every byte crosses device
// memory once, two blocks share each multiprocessor so that one's epilogue
// runs under the other's products, and the tensor cores run under the
// loads.
// - Tiles of 128 tokens x BN outputs, BN one of the widths below up to 128
//   (the wrapper's rule: the fewest tiles of at most 128 columns that cover
//   N, rounded up to a width), so that narrow outputs pay little for
//   padding.  N is padded to BN in shared memory (zero rows of W); padded
//   columns are not stored.  (Tiles 256 wide read x from L2 half as often
//   but hold one block a multiprocessor, whose epilogue then stalls the
//   tensor cores: 26 % slower over MOF's convolutions on an H100.)
// - Two consumer warpgroups of 64 tokens each (256 threads) run wgmma
//   m64nBNk16 with both operands in shared memory, K-major, 128-byte
//   swizzle, f32 accumulators in registers (up to 64 a thread).
// - Loads are cp.async into a ring of three or four stages of 64 k each;
//   each thread copies 16-byte pieces where the row stride and the address
//   allow, else 8, 4 or 2 bytes, and zero-fills what lies past M, N or K (a
//   piece that straddles K copies its part before K).  K = 324, 486, 972
//   give row strides that TMA cannot describe and 16-byte pieces cannot
//   start every row of; the FFN's middle tensor, which K8 writes and only
//   K8 reads, is written with its rows padded to 8 elements (y's row
//   stride), so the next launch reads it in 16-byte pieces, and such a
//   weight is read from a copy with padded rows that the wrapper makes once
//   per version of the weight (ldw).  No pass pads or re-lays-out an
//   activation.
// - The grid is persistent, two blocks a multiprocessor: each block walks
//   its tiles as one stream of k-steps, stages - 1 steps ahead, across tile
//   boundaries, so the next tile's first loads are in flight while this
//   tile's epilogue runs.  Tiles that share a block of tokens are
//   adjacent, so x is read from memory once and from L2 for the other
//   column tiles; W stays in L2.
// - A step's products are issued, then the copies of a later step, then
//   the block waits for the products (wait_group 0); a stage is refilled
//   only after a barrier that every warpgroup reaches with its products of
//   that stage complete.
// - The epilogue copies the residual tile into the stage its last step
//   freed (16-byte pieces where the rows allow) and the bias beside it, in
//   one round trip to memory, then adds them, applies the activation in
//   f32 and writes y once, straight from the accumulator registers.
//   (Loading them into registers under the products instead spilled at
//   128 registers a thread and ran 11-23 % slower on an H100.)
//
// The f32 entry is a plain tiled FMA kernel on the CUDA cores (no TF32):
// f32 tensors on the card (the card-vs-CPU parity runs) take it; no cell
// runs it.
//
// Bounds guards (bounds.cuh, checked build): every load of x, W, the bias
// and the residual, and every store of y, against its tensor's extent.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kBM = 128;                // tokens of a tile: two warpgroups of 64
constexpr int kBK = 64;                 // k of a stage: one 128-byte swizzle row of bf16
constexpr int kThreads = 256;
constexpr int kSmemPerBlock = 113 * 1024;  // two blocks a multiprocessor (228 KB, 1 KB each reserved)

struct Extents {  // elements of x, W, bias, res and y (bounds guards)
  long long x, w, bias, res, y;
};

// A block's shared memory: the ring (x rows, then W rows, a stage) and the
// tile's bias.  Four stages where two blocks still fit a multiprocessor,
// else three; k-steps in flight ahead of the one multiplied: stages - 1.
// The residual tile (128 x BN bf16) fits the stage that a tile's last step
// frees (BN <= 128).
template <int BN>
struct Tile {
  static constexpr int kStageBytes = (kBM + BN) * 128;
  static constexpr int kFixed = 2 * BN + 1024;   // the bias, + alignment slack
  static constexpr int kStages = 4 * kStageBytes + kFixed <= kSmemPerBlock ? 4 : 3;
  static constexpr int kSmem = kStages * kStageBytes + kFixed;
  static_assert(kSmem <= kSmemPerBlock && 2 * kBM * BN <= kStageBytes,
                "two blocks a multiprocessor; the residual tile in a stage");
  // Byte of the residual tile's (row, column): rows 2 BN bytes apart, their
  // 16-byte pieces swizzled where a row spans whole 128-byte lines, so that
  // the epilogue's reads of 8 rows x 4 column pairs fall in distinct banks.
  static __device__ __forceinline__ int res_byte(int r, int c) {
    return r * 2 * BN + ((2 * c) ^ (BN % 64 == 0 ? (r & 7) << 4 : 0));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: sbo = bytes
// between 8-row groups (lbo is not read for this layout).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators at this point of the program, so that the compiler
// moves no read or write of them across a fence or a wait.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B for A 64x16 and B 16xN, both read from shared memory through
// descriptors, both K-major; acc = 0 overwrites d.  One specialization per
// tile width (the instruction's N is part of its name).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void mma(float (&d)[56], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
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
};


// One piece of VEC bf16 values from global to shared memory, of which the
// first `bytes` come from src and the rest are zeros (src-size).  VEC = 1
// has no cp.async form: a plain load.
template <int VEC>
__device__ __forceinline__ void copy(uint32_t dst, const __nv_bfloat16* src, int bytes);
template <>
__device__ __forceinline__ void copy<8>(uint32_t dst, const __nv_bfloat16* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
template <>
__device__ __forceinline__ void copy<4>(uint32_t dst, const __nv_bfloat16* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
template <>
__device__ __forceinline__ void copy<2>(uint32_t dst, const __nv_bfloat16* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
template <>
__device__ __forceinline__ void copy<1>(uint32_t dst, const __nv_bfloat16* src, int bytes) {
  const unsigned short v = bytes ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const __nv_bfloat16* x;
  long long lda;
  const __nv_bfloat16* w;
  long long ldw;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;   // or nullptr
  long long ldr;
  __nv_bfloat16* y;
  long long ldy;
  int M, K, N, act, vec, vec_w, res_vec;
  Extents ext;
};

// Rows [0, rows) of a stage's operand: k-columns [k0, k0 + 64) of the rows
// starting at `src` (ld elements apart, VEC dividing ld), of which the first
// `valid` exist; a piece that reaches past K copies what lies before K and
// zeros the rest.  Row r's 16-byte piece c lands at
// r * 128 + (16 c ^ 16 (r % 8)), the 128-byte swizzle the descriptors name.
template <int VEC>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, long long ld, int rows,
                                          int valid, int k0, int K, const __nv_bfloat16* t0,
                                          long long extent) {
  constexpr int kPer = kBK / VEC;
  for (int i = threadIdx.x; i < rows * kPer; i += kThreads) {
    const int r = i / kPer, c = i % kPer;
    const int k = k0 + c * VEC;
    const int n = r < valid ? min(max(K - k, 0), VEC) : 0;   // elements before K
    const __nv_bfloat16* p = n ? src + r * ld + k : t0;
    TF_GUARD_SPAN_IF(n, p - t0, n, extent);
    copy<VEC>(dst + r * 128 + ((c * VEC * 2) ^ ((r & 7) << 4)), p, 2 * n);
  }
}

template <int VEC>
__device__ __forceinline__ void load_x(uint32_t st, const Args& a, int m0, int k0) {
  load_rows<VEC>(st, a.x + (long long)m0 * a.lda, a.lda, kBM, a.M - m0, k0, a.K, a.x, a.ext.x);
}

template <int BN, int VEC>
__device__ __forceinline__ void load_w(uint32_t sw, const Args& a, int n0, int k0) {
  load_rows<VEC>(sw, a.w + (long long)n0 * a.ldw, a.ldw, BN, a.N - n0, k0, a.K, a.w, a.ext.w);
}

// x's rows and W's rows of k-step k0 into stage st; each operand copies
// pieces as wide as its row stride and address allow.
template <int BN>
__device__ __forceinline__ void load_stage(uint32_t st, const Args& a, int m0, int n0, int k0) {
  switch (a.vec) {
    case 8: load_x<8>(st, a, m0, k0); break;
    case 4: load_x<4>(st, a, m0, k0); break;
    case 2: load_x<2>(st, a, m0, k0); break;
    default: load_x<1>(st, a, m0, k0);
  }
  const uint32_t sw = st + kBM * 128;
  switch (a.vec_w) {
    case 8: load_w<BN, 8>(sw, a, n0, k0); break;
    case 4: load_w<BN, 4>(sw, a, n0, k0); break;
    case 2: load_w<BN, 2>(sw, a, n0, k0); break;
    default: load_w<BN, 1>(sw, a, n0, k0);
  }
}

// The residual tile [m0, m0 + 128) x [n0, n0 + BN) into shared memory at
// Tile<BN>::res_byte, zeros past M and N.  VEC divides N and ldr.
template <int BN, int VEC>
__device__ __forceinline__ void load_res_rows(uint32_t dst, const Args& a, int m0, int n0) {
  constexpr int kPer = BN / VEC;
  for (int i = threadIdx.x; i < kBM * kPer; i += kThreads) {
    const int r = i / kPer, c = (i % kPer) * VEC;
    const bool in = m0 + r < a.M && n0 + c < a.N;
    const __nv_bfloat16* p = in ? a.res + (long long)(m0 + r) * a.ldr + n0 + c : a.res;
    TF_GUARD_SPAN_IF(in, p - a.res, VEC, a.ext.res);
    copy<VEC>(dst + Tile<BN>::res_byte(r, c), p, in ? 2 * VEC : 0);
  }
}

template <int BN>
__device__ __forceinline__ void load_res(uint32_t dst, const Args& a, int m0, int n0) {
  switch (a.res_vec) {
    case 8: load_res_rows<BN, 8>(dst, a, m0, n0); break;
    case 4: load_res_rows<BN, 4>(dst, a, m0, n0); break;
    case 2: load_res_rows<BN, 2>(dst, a, m0, n0); break;
    default: load_res_rows<BN, 1>(dst, a, m0, n0);
  }
}

// core/encoders.gelu's bf16 form, 0.5 v (1 + tanh(u)) = v / (1 + exp(-2u)),
// u = sqrt(2 / pi) (v + 0.044715 v^3), in f32 (about 1e-6 relative, far
// under a bf16 step; exp(-2u) = inf gives -0).
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = 0.7978845608028654f * fmaf(0.044715f * v, v * v, v);
  return __fdividef(v, 1.0f + __expf(-2.0f * u));
}

// The exact erf form (the f32 entry).
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Accumulator entry i of a thread lies in row 16 * (warp % 4) + lane / 4
// + 8 * ((i >> 1) & 1) of its warpgroup's 64 and in column
// 8 * (i >> 2) + 2 * (lane % 4) + (i & 1) of the tile.  The residual and the
// bias come from shared memory (zeros past M and N); what lies past M or N
// is not stored.
template <int BN>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const Args& a, const uint8_t* res,
                                         const __nv_bfloat16* bias, int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);   // row in the tile
  const int cl = 2 * (lane & 3);                                      // column in the tile
  const bool out_pairs = (a.ldy & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + cl + 8 * j;
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + cl + 8 * j));
    const bool two = c + 1 < a.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + bv.x;
      float v1 = acc[4 * j + 2 * h + 1] + bv.y;
      if (res != nullptr) {
        const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            res + Tile<BN>::res_byte(rl + 8 * h, cl + 8 * j)));
        v0 = rv.x + v0;
        v1 = rv.y + v1;
      }
      if (a.act) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
      const int r = m0 + rl + 8 * h;
      if (r >= a.M || c >= a.N) continue;
      __nv_bfloat16* yp = a.y + (long long)r * a.ldy + c;
      TF_GUARD_SPAN(yp - a.y, two ? 2 : 1, a.ext.y);
      if (two && out_pairs) {
        *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
      } else {
        yp[0] = __float2bfloat16_rn(v0);
        if (two) yp[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2) pointwise_gemm_bf16_kernel(const Args a) {
  constexpr int kStages = Tile<BN>::kStages, kAhead = kStages - 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1 KB
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  __nv_bfloat16* const bias_s = reinterpret_cast<__nv_bfloat16*>(smem + kStages * Tile<BN>::kStageBytes);
  const int wg = threadIdx.x >> 7;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int tiles = ((a.M + kBM - 1) / kBM) * n_tiles;
  const int nk = (a.K + kBK - 1) / kBK;
  // This block's tiles are blockIdx.x, + gridDim.x, ...: one stream of
  // my_tiles * nk k-steps, step s in stage s % kStages.  Tiles of one block
  // of tokens are adjacent.
  const int my_tiles = tiles > (int)blockIdx.x ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = my_tiles * nk;
  auto load = [&](int s) {
    const int t = (int)blockIdx.x + (s / nk) * (int)gridDim.x;
    load_stage<BN>(base + (uint32_t)(s % kStages) * Tile<BN>::kStageBytes, a, (t / n_tiles) * kBM,
                   (t % n_tiles) * BN, (s % nk) * kBK);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  int s = 0;
  for (int i = 0; i < my_tiles; ++i) {
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
    for (int kt = 0; kt < nk; ++kt, ++s) {
      // Step s's copies (this thread's) have landed; the proxy fence makes
      // them visible to wgmma, the barrier everyone's.  Past the barrier
      // every warpgroup has finished its products of step s - 1, whose
      // stage the load of step s + kAhead refills while this step's
      // products run, and every thread has finished the last epilogue.
      cp_async_wait<kAhead - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t st = base + (uint32_t)(s % kStages) * Tile<BN>::kStageBytes;
      const uint32_t sa = st + wg * 64 * 128, sb = st + kBM * 128;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Wgmma<BN>::mma(acc, smem_desc(sa + kk * 32), smem_desc(sb + kk * 32), kt > 0 || kk > 0);
      wgmma_commit();
      if (s + kAhead < steps) load(s + kAhead);
      cp_async_commit();
      wgmma_wait<0>();
      pin(acc);
    }
    // The last step's stage is free once every warpgroup's products of it
    // are complete (the barrier); until the next tile's first step refills
    // it, it holds the residual tile.  The next tile's first copies are in
    // flight meanwhile, and the other block on the multiprocessor
    // multiplies.
    __syncthreads();
    const int last = (s - 1) % kStages;
    uint8_t* const res_s = smem + last * Tile<BN>::kStageBytes;
    if (a.res != nullptr) load_res<BN>(base + (uint32_t)last * Tile<BN>::kStageBytes, a, m0, n0);
    if ((int)threadIdx.x < BN) {
      const int c = min(n0 + (int)threadIdx.x, a.N - 1);
      TF_GUARD(c, a.ext.bias);
      bias_s[threadIdx.x] = a.bias[c];
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    epilogue<BN>(acc, a, a.res != nullptr ? res_s : nullptr, bias_s, m0, n0);
  }
  cp_async_wait<0>();
}

// The f32 entry: 64 x 64 tiles, k in steps of 16 through shared memory,
// 4 x 4 outputs a thread, exact f32 FMAs.
constexpr int kFT = 64;
constexpr int kFK = 16;

struct ArgsF32 {
  const float* x;
  long long lda;
  const float* w;
  const float* bias;
  const float* res;
  long long ldr;
  float* y;
  long long ldy;
  int M, K, N, act;
  Extents ext;
};

__global__ void __launch_bounds__(256) pointwise_gemm_f32_kernel(const ArgsF32 a) {
  __shared__ float xs[kFK][kFT + 4];  // [k][token]
  __shared__ float ws[kFK][kFT + 4];  // [k][output]
  const int m0 = blockIdx.x * kFT, n0 = blockIdx.y * kFT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += kFK) {
    for (int i = threadIdx.x; i < kFT * kFK; i += 256) {
      const int r = i / kFK, k = k0 + i % kFK;
      const bool xin = m0 + r < a.M && k < a.K;
      const bool win = n0 + r < a.N && k < a.K;
      const long long xi = (long long)(m0 + r) * a.lda + k, wi = (long long)(n0 + r) * a.K + k;
      TF_GUARD_IF(xin, xi, a.ext.x);
      TF_GUARD_IF(win, wi, a.ext.w);
      xs[i % kFK][r] = xin ? a.x[xi] : 0.0f;
      ws[i % kFK][r] = win ? a.w[wi] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = xs[k][ty * 4 + i];
        wv[i] = ws[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= a.N) continue;
      TF_GUARD(c, a.ext.bias);
      float v = acc[i][j] + a.bias[c];
      if (a.res != nullptr) {
        TF_GUARD((long long)r * a.ldr + c, a.ext.res);
        v = a.res[(long long)r * a.ldr + c] + v;
      }
      if (a.act) v = gelu_erf(v);
      TF_GUARD((long long)r * a.ldy + c, a.ext.y);
      a.y[(long long)r * a.ldy + c] = v;
    }
  }
}

template <int BN>
int launch_bf16(const Args& a, cudaStream_t s) {
  // Per device: the function's shared-memory limit, set once, and the
  // persistent grid (resident blocks a multiprocessor x multiprocessors).
  static int grid_cap[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  constexpr int smem = Tile<BN>::kSmem;
  if (grid_cap[dev] == 0) {
    rc = cudaFuncSetAttribute(pointwise_gemm_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    int per_sm = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pointwise_gemm_bf16_kernel<BN>, kThreads, smem);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    grid_cap[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long tiles = (long long)((a.M + kBM - 1) / kBM) * ((a.N + BN - 1) / BN);
  const int grid = (int)(tiles < grid_cap[dev] ? tiles : grid_cap[dev]);
  pointwise_gemm_bf16_kernel<BN><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (rows lda elements apart), w [N, K] (rows ldw apart; f32: K),
// bias [N], res [M, N] (rows ldr apart) or null, y [M, N] (rows ldy apart);
// dtype 0 = bf16, 1 = f32; act 0 = identity, 1 = GELU.  bf16 only: vec and
// vec_w, the elements a copy of x and of w moves (8, 4, 2 or 1; vec divides
// lda and vec_w divides ldw, and the addresses are 2 * vec-byte aligned),
// res_vec, the same for res
// (it divides N and ldr), bn, the tile width (8, or a multiple of 16 up to
// 128).  extents: host array of the elements of x, w, bias, res and y, read
// by the checked build only.  Returns the launch's cudaError_t.
extern "C" int tf_pointwise_gemm(int dtype, const void* x, long long lda, const void* w, long long ldw,
                                 const void* bias, const void* res, long long ldr, void* y, long long ldy, int M,
                                 int K, int N, int act, int vec, int vec_w, int bn, int res_vec,
                                 const long long* extents, void* stream) {
  if ((dtype != 0 && dtype != 1) || M < 1 || K < 1 || N < 1 || lda < K || ldw < K || ldy < N ||
      (act != 0 && act != 1) || (dtype == 1 && ldw != K) ||
      x == nullptr || w == nullptr || bias == nullptr || y == nullptr || (res != nullptr && ldr < N))
    return (int)cudaErrorInvalidValue;
  const Extents ext{extents[0], extents[1], extents[2], extents[3], extents[4]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const ArgsF32 a{static_cast<const float*>(x), lda, static_cast<const float*>(w),
                    static_cast<const float*>(bias), static_cast<const float*>(res), ldr,
                    static_cast<float*>(y), ldy, M, K, N, act, ext};
    const dim3 grid((unsigned)((M + kFT - 1) / kFT), (unsigned)((N + kFT - 1) / kFT));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    pointwise_gemm_f32_kernel<<<grid, 256, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  auto vec_ok = [](int v, long long ld) { return (v == 8 || v == 4 || v == 2 || v == 1) && ld % v == 0; };
  if (!vec_ok(vec, lda) || !vec_ok(vec_w, ldw) || (res != nullptr && (!vec_ok(res_vec, ldr) || N % res_vec)))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), lda, static_cast<const __nv_bfloat16*>(w), ldw,
               static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(res), ldr,
               static_cast<__nv_bfloat16*>(y), ldy, M, K, N, act, vec, vec_w, res_vec, ext};
  switch (bn) {
    case 8: return launch_bf16<8>(a, s);
    case 16: return launch_bf16<16>(a, s);
    case 32: return launch_bf16<32>(a, s);
    case 48: return launch_bf16<48>(a, s);
    case 64: return launch_bf16<64>(a, s);
    case 80: return launch_bf16<80>(a, s);
    case 96: return launch_bf16<96>(a, s);
    case 112: return launch_bf16<112>(a, s);
    case 128: return launch_bf16<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
