// K9: MemFlow's memory reader (core/memflownet.py MemoryReader) in one
// launch: an exact f32 cross-attention of this frame's queries over every
// token of the memory's valid slots, with the scores kept on chip.
//
// It replaces no TPU kernel: the JAX reader (tpuflow/core/memflownet.py,
// MemoryReader, lines 133-188) is XLA einsums.  It was added because the
// port's plain reader wrote a [rows, cap * hw] f32 score tensor for each
// chunk of queries, masked it, softmaxed it into a second one and
// multiplied that by the values: at 1080p, 33.6 GB of scores a frame, each
// passing device memory about six times, and the slots that the mask then
// threw away computed all the same (146 ms a frame on an H100).
//
// What it computes, for query q [B, hw, 64] (bf16 or f32), keys
// [B, cap, hw, 64] and values [B, cap, hw, 128] (f32, as the memory stores
// them), valid [B, cap] (f32, > 0 where a slot holds a frame) and an
// optional RoPE table [hw, 2, 32] (f32: cos, then sin, of each of the 32
// channel pairs' angles at each position):
//   read[b, i, :] = sum over valid s, j of softmax_{s,j}(rope(q[b,i] * scale) . rope(k[b,s,j])) v[b,s,j,:]
// in f32 throughout: products and sums as f32 FMAs on the CUDA cores (no
// TF32, no bf16), an online softmax with an f32 running maximum and sum,
// and expf (CUDA's, within 2 ulp).  A row whose batch row has no valid slot
// reads zeros.  rope rotates channel pair p of a token (channels c and
// c + 16, c = (p / 16) * 32 + p % 16) by the table's angle at the token's
// position, with separately rounded products as core/memflownet.rope_2d
// computes them; scale is 1 / sqrt(64), exact.  The plain version is
// tpuflow_torch/kernels/memread.py:memory_read_plain.
//
// Bound on an H100.  2 * hw * (valid slots * hw) * (64 + 128) operations on
// the CUDA cores' f32 FMAs (67 TFLOP/s): 3.23 TFLOP, 48.13 ms, at 8 slots
// of the 1080p grid (hw = 32 400); the bytes (keys, values, the query, the
// readout) are 0.2 GB, 0.06 ms at 3.35 TB/s.  The tensor cores offer no
// exact f32 product (TF32 or bf16 would change the function), so the
// operations bound it.
//
// Design: keep the scores on chip and feed the FMA units from registers,
// with as few shared-memory loads an FMA as 255 registers a thread allow.
// - A block owns 128 query rows of one batch row (256 threads; the grid is
//   ceil(hw / 128) x B).  It lists the valid slots once, from `valid` on
//   the device, and walks only their key tiles of 64 tokens: an invalid
//   slot costs nothing, and a memory with no valid slot writes zeros at
//   once.  That skip is the plain version's mask exactly: a masked score
//   there is -1e9, whose exp against any valid token's maximum is 0 in f32.
// - The query tile is scaled, rotated and staged once (128 x 64 f32).  Key
//   tiles and their values are staged by cp.async in a three-stage ring,
//   each tile's key chunks by the thread that will rotate them, so that the
//   rotation needs no barrier of its own.  Tiles run position by position,
//   each position through the valid slots, so that the two tiles a thread
//   rotates at once mostly share the table rows it reads into registers.
// - Tiles go in pairs.  Each thread scores 8 query rows against 4 keys of
//   each tile of the pair (keys strided by 16, so that a quarter warp's
//   loads hit distinct banks): 256 FMAs for 16 16-byte loads a step of 4
//   channels.  Rows' maxima meet by shuffles across the 16 threads of a
//   row, once a pair; each thread keeps its own partial sum under the
//   row's maximum, and the sums meet once, at the end.
// - Each tile's probabilities go to shared memory transposed, into the
//   rows of the warp that computed them, and that warp alone reads them
//   back: 8 rows x 8 value channels of the [128, 128] readout in
//   registers, 64 FMAs a key for four 16-byte loads.  Two block barriers a
//   pair: one before the stage of the pair's first tile is refilled, one
//   after the next pair's keys are rotated.
// - One block an SM (214 KB of shared memory, up to 255 registers a
//   thread): at 1080p, 254 query tiles in two waves over 132 SMs.
//
// What holds it back (H100 at 700 W, 1980 MHz under this load; 8 valid
// slots of the 1080p grid): 83.0-83.5 ms, 57.6-58.0 % of the f32 FMA
// bound, against 144-145 ms for the plain version.  Timed with parts taken
// out: the score products run at about 75 % of the FMA rate and the
// readout's at about 90 %; staging costs 5 ms, the rotation 3 ms, the
// exponentials and the rows' maxima 3.5 ms, the second wave's idle SMs
// 3.8 %.  Tried and slower: single tiles (scores 8 x 4 a thread, 88 ms),
// 512 threads of 4 rows each (93 ms), a warp vote to skip the rescale
// where no maximum grew (+7 ms), one copy of the readout's code for both
// tiles.  The next design overlaps one group of warps' softmax with
// another's products (two consumer warpgroups taking turns) and stages the
// values with bulk copies from a producer warp.
//
// Bounds guards (bounds.cuh, checked build): every global load (the query,
// the table, each cp.async source, valid) and every store of the readout,
// against its tensor's extent.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kDk = 64;          // key channels (the kernel is built for MemFlow's)
constexpr int kDv = 128;         // value channels
constexpr int kPairs = kDk / 2;  // rotated channel pairs a token
constexpr int kRows = 128;       // query rows a block
constexpr int kKeys = 64;        // keys a tile
constexpr int kRowsPerThread = 8;                  // a multiple of 4
constexpr int kThreads = 16 * kRows / kRowsPerThread;  // 16 threads a row group
constexpr int kKeysPerThread = 4;
constexpr int kColsPerThread = 8;  // readout channels: 4 at tx * 4, 4 at 64 + tx * 4

// Shared-memory pitches in floats.  Rows of Q and K are padded by 4, so
// that a quarter warp's 16-byte loads down a column of rows (keys strided
// by 16) fall in distinct banks; V's rows are read along their length.
constexpr int kQPitch = kDk + 4;
constexpr int kKPitch = kDk + 4;
constexpr int kVPitch = kDv;
constexpr int kPPitch = kRows + 4;
constexpr int kStages = 3;

constexpr int kQFloats = kRows * kQPitch + 4;
constexpr int kKFloats = kKeys * kKPitch;
constexpr int kVFloats = kKeys * kVPitch;
constexpr int kStageFloats = kKFloats + kVFloats;
constexpr int kPFloats = kKeys * kPPitch;
constexpr int kSmemFloats = kQFloats + kStages * kStageFloats + kPFloats;
// Pair groups (4 pairs of one key) of a tile that each thread rotates.
constexpr int kGroupsPerThread = kKeys * (kPairs / 4) / kThreads;

struct Extents {
  long long q, keys, values, valid, table, out;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Offset of query row R in shared memory.  The two row groups of a warp
// read rows kRowsPerThread apart, which a pitch of 68 puts in the same
// banks; every other group is skewed by 4 floats, so that their broadcast
// loads fall in different banks.
__device__ __forceinline__ int q_row(int R) {
  return R * kQPitch + ((static_cast<unsigned>(R) / kRowsPerThread) & 1u) * 4;
}

// Channel of the first member of rotated pair p (the second is 16 on).
__device__ __forceinline__ int pair_channel(int p) { return (p >> 4) * 32 + (p & 15); }

// rope_2d's rotation of one pair, each product rounded on its own.
__device__ __forceinline__ void rotate(float& x1, float& x2, float c, float s) {
  const float r1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  const float r2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
  x1 = r1;
  x2 = r2;
}

// This thread's pair groups of a key tile: group u holds the 4 pairs
// starting at pair p0 of key row r, whose channels are the 16-byte chunks
// c1 / 4 and c1 / 4 + 4 of that row.  The thread stages those chunks
// itself, so that it can rotate them as soon as its own copies land.
__device__ __forceinline__ void pair_group(int tid, int u, int& r, int& p0, int& c1) {
  const int e = tid + u * kThreads;
  r = e / (kPairs / 4);
  p0 = (e % (kPairs / 4)) * 4;
  c1 = pair_channel(p0);
}

// Stage the keys and values of tokens j0 .. j0 + 63 of one slot (its row
// `slot_row` of [B * cap]) into a ring stage, as one cp.async group; rows
// past hw are filled with zeros.
__device__ __forceinline__ void load_tile(float* stage, const float* __restrict__ keys,
                                          const float* __restrict__ values, long long slot_row,
                                          int j0, int hw, int tid, const Extents& ext) {
  float* ks = stage;
  float* vs = stage + kKFloats;
  const float* kb = keys + (slot_row * hw + j0) * kDk;
  const float* vb = values + (slot_row * hw + j0) * kDv;
#pragma unroll
  for (int u = 0; u < kGroupsPerThread; ++u) {
    int r, p0, c1;
    pair_group(tid, u, r, p0, c1);
    const bool in = j0 + r < hw;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c1 + 16 * half;
      const float* src = in ? kb + r * kDk + c : keys;
      TF_GUARD_SPAN(src - keys, 4, ext.keys);
      cp_async16(ks + r * kKPitch + c, src, in);
    }
  }
#pragma unroll
  for (int u = 0; u < kKeys * (kDv / 4) / kThreads; ++u) {
    const int c = tid + u * kThreads, r = c / (kDv / 4), q4 = c % (kDv / 4);
    const bool in = j0 + r < hw;
    const float* src = in ? vb + r * kDv + q4 * 4 : values;
    TF_GUARD_SPAN(src - values, 4, ext.values);
    cp_async16(vs + r * kVPitch + q4 * 4, src, in);
  }
  cp_async_commit();
}

// The table rows of this thread's pair groups of the tile at j0 (cos and
// sin of 4 pairs each), into registers; zeros past hw.
__device__ __forceinline__ void load_angles(float4 (&cs)[kGroupsPerThread],
                                            float4 (&sn)[kGroupsPerThread],
                                            const float* __restrict__ table, int j0, int hw,
                                            int tid, const Extents& ext) {
#pragma unroll
  for (int u = 0; u < kGroupsPerThread; ++u) {
    int r, p0, c1;
    pair_group(tid, u, r, p0, c1);
    cs[u] = sn[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + r < hw) {
      const long long t = (long long)(j0 + r) * kDk + p0;
      TF_GUARD_SPAN(t, 4, ext.table);
      TF_GUARD_SPAN(t + kPairs, 4, ext.table);
      cs[u] = __ldg(reinterpret_cast<const float4*>(table + t));
      sn[u] = __ldg(reinterpret_cast<const float4*>(table + t + kPairs));
    }
  }
}

// Rotate this thread's own pair groups of a staged key tile in place.
__device__ __forceinline__ void rotate_tile(float* ks, const float4 (&cs)[kGroupsPerThread],
                                            const float4 (&sn)[kGroupsPerThread], int tid) {
#pragma unroll
  for (int u = 0; u < kGroupsPerThread; ++u) {
    int r, p0, c1;
    pair_group(tid, u, r, p0, c1);
    float4 a = *reinterpret_cast<float4*>(ks + r * kKPitch + c1);
    float4 z = *reinterpret_cast<float4*>(ks + r * kKPitch + c1 + 16);
    rotate(a.x, z.x, cs[u].x, sn[u].x);
    rotate(a.y, z.y, cs[u].y, sn[u].y);
    rotate(a.z, z.z, cs[u].z, sn[u].z);
    rotate(a.w, z.w, cs[u].w, sn[u].w);
    *reinterpret_cast<float4*>(ks + r * kKPitch + c1) = a;
    *reinterpret_cast<float4*>(ks + r * kKPitch + c1 + 16) = z;
  }
}

// The probabilities of one tile (keys tx + 16 * c of rows ty * 8 + r),
// transposed into this warp's rows of pt, then this warp's readout of the
// tile: rows ty * 8 + r, channels tx * 4 + u and 64 + tx * 4 + u.  A warp
// reads only the rows it wrote.
__device__ __forceinline__ void readout(float (&o)[kRowsPerThread][kColsPerThread],
                                        const float (&p)[kRowsPerThread][kKeysPerThread],
                                        float* pt, const float* vs, int tx, int ty) {
#pragma unroll
  for (int c = 0; c < kKeysPerThread; ++c)
#pragma unroll
    for (int h = 0; h < kRowsPerThread; h += 4)
      *reinterpret_cast<float4*>(pt + (tx + 16 * c) * kPPitch + ty * kRowsPerThread + h) =
          make_float4(p[h][c], p[h + 1][c], p[h + 2][c], p[h + 3][c]);
  __syncwarp();
#pragma unroll 16
  for (int kk = 0; kk < kKeys; ++kk) {
    float pr[kRowsPerThread];
#pragma unroll
    for (int h = 0; h < kRowsPerThread; h += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * kPPitch + ty * kRowsPerThread + h);
      pr[h] = p4.x, pr[h + 1] = p4.y, pr[h + 2] = p4.z, pr[h + 3] = p4.w;
    }
    const float4 v0 = *reinterpret_cast<const float4*>(vs + kk * kVPitch + tx * 4);
    const float4 v1 = *reinterpret_cast<const float4*>(vs + kk * kVPitch + 64 + tx * 4);
    const float v[kColsPerThread] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) o[r][c] = fmaf(pr[r], v[c], o[r][c]);
  }
  __syncwarp();
}

template <typename TQ, bool kRope>
__global__ void __launch_bounds__(kThreads, 1) memory_read_kernel(
    const TQ* __restrict__ q, const float* __restrict__ keys, const float* __restrict__ values,
    const float* __restrict__ valid, const float* __restrict__ table, float* __restrict__ out,
    int cap, int hw, float scale, Extents ext) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = qs + kQFloats;
  float* pt = ring + kStages * kStageFloats;
  int* slots = reinterpret_cast<int*>(pt + kPFloats);
  __shared__ int n_valid;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRows;

  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < cap; ++s) {
      TF_GUARD((long long)b * cap + s, ext.valid);
      if (valid[(long long)b * cap + s] > 0.f) slots[n++] = b * cap + s;
    }
    n_valid = n;
  }
  __syncthreads();
  // Tiles run through the token positions 64 at a time, and at each
  // position through the valid slots, so that consecutive tiles share
  // their rotation angles; tile n lies in ring stage n % 3.  The cursor
  // (slot, j0) names the next tile to stage.
  const int tiles = n_valid * ((hw + kKeys - 1) / kKeys);
  int next = 0, cur_slot = 0, cur_j0 = 0;
  auto stage_of = [&](int n) { return ring + (n % kStages) * kStageFloats; };
  auto j0_of = [&](int n) { return (n / n_valid) * kKeys; };
  auto issue = [&]() {
    load_tile(stage_of(next), keys, values, slots[cur_slot], cur_j0, hw, tid, ext);
    ++next;
    if (++cur_slot == n_valid) {
      cur_slot = 0;
      cur_j0 += kKeys;
    }
  };
  // Rotate this thread's own chunks of tile n and, where it exists, tile
  // n + 1, whose copies have landed; the angles of tile n's positions are
  // in cs, sn, and are read again only where tile n + 1's positions differ.
  float4 cs[kGroupsPerThread], sn[kGroupsPerThread];
  auto rotate_two = [&](int n) {
    rotate_tile(stage_of(n), cs, sn, tid);
    if (n + 1 < tiles) {
      if (j0_of(n + 1) != j0_of(n)) load_angles(cs, sn, table, j0_of(n + 1), hw, tid, ext);
      rotate_tile(stage_of(n + 1), cs, sn, tid);
    }
  };

  if (tiles > 0) issue();
  if (tiles > 1) issue();

  // The query tile: scaled, rotated, zeros past hw.
  for (int e = tid; e < kRows * (kPairs / 4); e += kThreads) {
    const int r = e / (kPairs / 4), p0 = (e % (kPairs / 4)) * 4;
    const int c1 = pair_channel(p0), c2 = c1 + 16;
    const int i = i0 + r;
    float x1[4] = {0.f, 0.f, 0.f, 0.f}, x2[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < hw) {
      const long long row = ((long long)b * hw + i) * kDk;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        TF_GUARD(row + c1 + u, ext.q);
        TF_GUARD(row + c2 + u, ext.q);
        x1[u] = __fmul_rn(to_f32(q[row + c1 + u]), scale);
        x2[u] = __fmul_rn(to_f32(q[row + c2 + u]), scale);
      }
      if (kRope) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long t = (long long)i * kDk + p0 + u;
          TF_GUARD(t, ext.table);
          TF_GUARD(t + kPairs, ext.table);
          rotate(x1[u], x2[u], table[t], table[t + kPairs]);
        }
      }
    }
    *reinterpret_cast<float4*>(qs + q_row(r) + c1) = make_float4(x1[0], x1[1], x1[2], x1[3]);
    *reinterpret_cast<float4*>(qs + q_row(r) + c2) = make_float4(x2[0], x2[1], x2[2], x2[3]);
  }
  if (kRope && tiles > 0) load_angles(cs, sn, table, 0, hw, tid, ext);
  cp_async_wait<0>();
  if (kRope && tiles > 0) rotate_two(0);
  __syncthreads();

  float o[kRowsPerThread][kColsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) o[r][c] = 0.f;
  }

  // Tiles in pairs (a, a + 1), both staged and rotated on entry, so that
  // each thread's scores are 8 rows x 8 keys: 16 16-byte loads a step of 4
  // channels for 256 FMAs.  Tile a + 2 loads into the stage that tile
  // a - 1 left; tile a + 3 into tile a's once every warp has read it.  At
  // the pair's end each thread rotates its own chunks of both, and one
  // barrier makes them visible.
  for (int a = 0; a < tiles; a += 2) {
    const bool has_b = a + 1 < tiles;
    const int j0a = j0_of(a), j0b = j0_of(a + 1);
    const float* ksa = stage_of(a);
    const float* ksb = stage_of(a + 1);
    if (next < tiles) issue();                         // tile a + 2

    float s[kRowsPerThread][2 * kKeysPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < 2 * kKeysPerThread; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kDk; d += 4) {
      float4 kf[2 * kKeysPerThread];
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        kf[c] = *reinterpret_cast<const float4*>(ksa + (tx + 16 * c) * kKPitch + d);
        kf[kKeysPerThread + c] = *reinterpret_cast<const float4*>(ksb + (tx + 16 * c) * kKPitch + d);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        // q_row(ty * kRowsPerThread + r) + d written out, which compiles to
        // a faster loop (1.5 ms at 8 valid slots of the 1080p grid).
        const float4 qf = *reinterpret_cast<const float4*>(
            qs + (ty * kRowsPerThread + r) * kQPitch + (ty & 1) * 4 + d);
#pragma unroll
        for (int c = 0; c < 2 * kKeysPerThread; ++c) {
          s[r][c] = fmaf(qf.x, kf[c].x, s[r][c]);
          s[r][c] = fmaf(qf.y, kf[c].y, s[r][c]);
          s[r][c] = fmaf(qf.z, kf[c].z, s[r][c]);
          s[r][c] = fmaf(qf.w, kf[c].w, s[r][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2 * kKeysPerThread; ++c) {
      const int j = (c < kKeysPerThread ? j0a : j0b) + tx + 16 * (c % kKeysPerThread);
      if (j >= hw || (c >= kKeysPerThread && !has_b))
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) s[r][c] = -INFINITY;
    }

    // Online softmax over the pair: the row's maximum across its 16
    // threads, each thread's own partial sum.
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int c = 1; c < 2 * kKeysPerThread; ++c) mx = fmaxf(mx, s[r][c]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) o[r][c] *= alpha;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2 * kKeysPerThread; ++c) {
        s[r][c] = expf(s[r][c] - mn);
        sum += s[r][c];
      }
      l[r] += sum;
    }

    float p[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) p[r][c] = s[r][c];
    readout(o, p, pt, ksa + kKFloats, tx, ty);
    __syncthreads();                                   // every warp is done with tile a's stage
    if (next < tiles) issue();                         // tile a + 3
    if (has_b) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kKeysPerThread; ++c) p[r][c] = s[r][kKeysPerThread + c];
      if (kRope && a + 2 < tiles) load_angles(cs, sn, table, j0_of(a + 2), hw, tid, ext);
      readout(o, p, pt, ksb + kKFloats, tx, ty);
      cp_async_wait<0>();
      if (kRope && a + 2 < tiles) rotate_two(a + 2);
    }
    __syncthreads();
  }

  // The rows' sums meet; a batch row with no valid slot writes zeros.
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    float sum = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int i = i0 + ty * kRowsPerThread + r;
    if (i >= hw) continue;
    float res[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) res[c] = tiles > 0 ? o[r][c] / sum : 0.f;
    float* row = out + ((long long)b * hw + i) * kDv;
    TF_GUARD_SPAN(row + tx * 4 - out, 4, ext.out);
    TF_GUARD_SPAN(row + 64 + tx * 4 - out, 4, ext.out);
    *reinterpret_cast<float4*>(row + tx * 4) = make_float4(res[0], res[1], res[2], res[3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) = make_float4(res[4], res[5], res[6], res[7]);
  }
}

template <typename TQ, bool kRope>
int launch(const void* q, const float* keys, const float* values, const float* valid,
           const float* table, float* out, int batch, int cap, int hw, float scale,
           const Extents& ext, cudaStream_t s) {
  // The slot list follows the buffers; with the block's static int, at
  // most the 227 KB a block may hold.
  const size_t smem = kSmemFloats * sizeof(float) + (size_t)cap * sizeof(int);
  if (smem + 16 > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(
      memory_read_kernel<TQ, kRope>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (hw + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  memory_read_kernel<TQ, kRope><<<dim3((unsigned)blocks, batch), kThreads, smem, s>>>(
      static_cast<const TQ*>(q), keys, values, valid, table, out, cap, hw, scale, ext);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = bf16, 1 = f32.  q [batch, hw, dk]; keys [batch, cap, hw, dk],
// values [batch, cap, hw, dv], valid [batch, cap] (f32, all contiguous;
// keys, values and table 16-byte aligned); table [hw, 2, dk / 2] f32, or
// null for no rotation; out [batch, hw, dv] f32.  dk must be 64 and dv 128
// (the kernel's build).  extents: the elements of q, keys, values, valid,
// table and out (read by the checked build).  Returns the launch's
// cudaError_t.
extern "C" int tf_memory_read(int q_dtype, const void* q, const float* keys, const float* values,
                              const float* valid, const float* table, float* out, int batch,
                              int cap, int hw, int dk, int dv, float scale,
                              const long long* extents, void* stream) {
  if ((q_dtype != 0 && q_dtype != 1) || dk != kDk || dv != kDv || batch < 1 || cap < 1 || hw < 1)
    return (int)cudaErrorInvalidValue;
  const Extents ext{extents[0], extents[1], extents[2], extents[3], extents[4], extents[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return table ? launch<__nv_bfloat16, true>(q, keys, values, valid, table, out, batch, cap, hw,
                                               scale, ext, s)
                 : launch<__nv_bfloat16, false>(q, keys, values, valid, table, out, batch, cap,
                                                hw, scale, ext, s);
  return table ? launch<float, true>(q, keys, values, valid, table, out, batch, cap, hw, scale, ext,
                                     s)
               : launch<float, false>(q, keys, values, valid, table, out, batch, cap, hw, scale,
                                      ext, s);
}
