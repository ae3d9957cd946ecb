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
// Bound on an H100: operations.  At the 1080p main path (B = 6, S = 16200,
// d = 128) one call is 4*B*S^2*d = 8.1e11 FLOP, 0.82 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 75 MB of q/k/v/out traffic (0.02 ms).
//
// Design (bf16): one block of 4 warps per 64 query rows, 16 rows per warp.
// Each warp keeps its Q rows as mma.sync A fragments in registers for the
// whole key loop.  Key/value tiles of 64 rows are staged in shared memory
// (rows padded to 136 elements so the fragment loads are free of bank
// conflicts).  Scores S = Q K^T and the update O += P V run on the tensor
// cores with m16n8k16 bf16 mma.sync and f32 accumulation; the score
// accumulator layout equals the A-fragment layout of P, so P never leaves
// registers.  The softmax is the online (running max / running sum) form in
// f32.  What it leaves for later work: no cp.async / TMA double buffering of
// the K/V tiles and no wgmma, so the tensor cores idle while a tile loads.
//
// The f32 entry is a plain FMA kernel (one warp per query row, exact f32
// dot products and softmax), used when the model runs in f32 — the
// CPU-vs-card parity run — and never on the bf16 main path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;               // head dim
constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;  // 64 query rows per block
constexpr int kBlockK = 64;           // keys per tile
constexpr int kLds = kD + 8;          // padded smem row, in bf16 elements
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* __restrict__ base,
                                              int row, int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * kD + col);
}

__global__ void __launch_bounds__(32 * kWarps) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kLds];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread within the group
  const size_t base = (size_t)blockIdx.y * S * kD;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;  // this thread's rows
  const int r1 = r0 + 8;

  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = load_pair(qb, r0, c, S);
    qf[kk][1] = load_pair(qb, r1, c, S);
    qf[kk][2] = load_pair(qb, r0, c + 8, S);
    qf[kk][3] = load_pair(qb, r1, c + 8, S);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row max
  float l0 = 0.0f, l1 = 0.0f;                    // this thread's share of the row sum

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * (kD / 8); idx += 32 * kWarps) {
      const int row = idx / (kD / 8);
      const int ch = idx - row * (kD / 8);
      const int key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)key * kD + ch * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)key * kD + ch * 8);
      }
      *reinterpret_cast<uint4*>(&ks[row * kLds + ch * 8]) = kv;
      *reinterpret_cast<uint4*>(&vs[row * kLds + ch * 8]) = vv;
    }
    __syncthreads();

    // Scores for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float sc[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
      const __nv_bfloat16* krow = &ks[(n * 8 + g) * kLds + tg * 2];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(sc[n], qf[kk], b0, b1);
      }
    }
    if (k0 + kBlockK > S) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + tg * 2 + (e & 1) >= S) sc[n][e] = -CUDART_INF_F;
        }
      }
    }

    // Online softmax: new row max over the 4 threads that share a row.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Tile 0 always holds key 0, so the max is finite from the first tile
    // on and exp2(-inf) = 0 rescales the empty initial state.
    const float a0 = exp2f((m0 - mx0) * kLog2e);
    const float a1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // P = exp(S - max) packed straight into A fragments (16 keys each).
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const float p0 = exp2f((sc[n][0] - mx0) * kLog2e);
      const float p1 = exp2f((sc[n][1] - mx0) * kLog2e);
      const float p2 = exp2f((sc[n][2] - mx1) * kLog2e);
      const float p3 = exp2f((sc[n][3] - mx1) * kLog2e);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[n / 2][(n & 1) * 2 + 0] = pack_f32(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_f32(p2, p3);
    }

    // O += P V: 16 n-tiles of 8 head-dim columns, 4 k-steps of 16 keys.
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + g;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const int key = kk * 16 + tg * 2;
        const uint32_t b0 = pack_bf16(vs[key * kLds + col], vs[(key + 1) * kLds + col]);
        const uint32_t b1 = pack_bf16(vs[(key + 8) * kLds + col], vs[(key + 9) * kLds + col]);
        mma_16816(acc[n], pf[kk], b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0;
  const float inv1 = 1.0f / l1;
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = n * 8 + tg * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kD + c) =
          pack_f32(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kD + c) =
          pack_f32(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

constexpr int kF32Warps = 4;

// One warp per query row; lane i holds head dims 4i..4i+3.
__global__ void __launch_bounds__(32 * kF32Warps) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, long long rows) {
  const long long row = (long long)blockIdx.x * kF32Warps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)(row / S) * S * kD;
  const float4 qv = reinterpret_cast<const float4*>(q + (size_t)row * kD)[lane];
  float m = -CUDART_INF_F, l = 0.0f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < S; ++j) {
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
  reinterpret_cast<float4*>(o + (size_t)row * kD)[lane] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

}  // namespace

// q, k, v, o: [B, S, 128] contiguous, 16-byte aligned.  dtype: 0 = bf16,
// 1 = f32.  Returns the launch's cudaError_t.
extern "C" int tf_flash_attention_fwd(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      void* stream) {
  if (B < 1 || S < 1 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((unsigned)((S + kBlockQ - 1) / kBlockQ), (unsigned)B);
    flash_fwd_bf16_kernel<<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S);
  } else {
    const long long rows = (long long)B * S;
    const unsigned blocks = (unsigned)((rows + kF32Warps - 1) / kF32Warps);
    flash_fwd_f32_kernel<<<blocks, 32 * kF32Warps, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, rows);
  }
  return (int)cudaGetLastError();
}
