// Kernel B: exact patch of a materialized correlation volume, every level
// of a lookup in one launch.  One function serves two TPU kernels, which
// differ only in the volume's layout:
//   K4 `dense_patch_level` (tpuflow/kernels/denselookup.py:156, body
//      `_kernel` :49), behind DenseCorrPyramid.lookup(impl='patch'), reads a
//      query-major volume;
//   K6 `band_patch_level` (tpuflow/kernels/bandlookup.py:184, body
//      `_band_kernel` :75), behind BandCorrPyramid, reads a plane-row-outer
//      volume [B, lh, Nq, lw].
//
// What it computes, for every level l, query n = (b, q) and clamped patch
// indices rr, cc [B, Nq, side]:
//   patch_l[b, q, i, j] = vol_l[b*sb + q*sq + rr[b,q,i]*sr + cc[b,q,j]]
// a pure copy of volume entries (strides in elements; columns are
// contiguous: flat [B*Nq, lh, lw] is sb = Nq*lh*lw, sq = lh*lw, sr = lw;
// the band layout is sb = lh*Nq*lw, sr = Nq*lw, sq = lw).  It equals its
// plain versions (tpuflow_torch/kernels/denselookup.py:dense_patch_level_plain,
// bandlookup.py:band_patch_level_plain) bit for bit.
//
// The TPU kernels select rows and columns with one-hot matrix products over
// grouped or banded slabs of the volume; the grouping, the lane and row
// padding and the per-block row ranges serve Mosaic's DMA and are not
// carried over.
//
// Bound on an H100: bytes, with no arithmetic.  At the 960x1080 tile
// (6 x 16 200 queries, 4 bf16 levels, side 10) a lookup writes 77.8 MB,
// reads 31.1 MB of indices and about 53 MB of distinct entries, which lie
// in patch rows of 20 bytes at 2-byte alignment: about 1.56 32-byte sectors
// a row, so the reads cost about 2.5x their distinct bytes.
//
// Design, for that:
// - One launch for every level (blockIdx.y), so a lookup pays one launch.
// - One warp per run of R consecutive queries of one level (as many as a
//   2 KB stage holds, 2..32: 10 at bf16 side 10).  The run's rr and cc are
//   read once, coalesced, every load issued before the first is used.  One
//   lane per query computes its base b*sb + q*sq (64-bit; one division per
//   run) and the shape of its columns; one lane per patch row computes the
//   row's read plan (the widening product rr*sr is the only other 64-bit
//   step; no division per row or entry).
// - The columns of a patch are a window: 2r+2 consecutive columns, some
//   clamped to the plane's left or right edge, i.e. `span` distinct
//   consecutive columns, the first repeated `lead` + 1 times, the last to
//   the end.  A group of lanes takes a patch row: lane g reads word g of the
//   aligned 4-byte words that hold the span (only words that hold an entry
//   of it: side/2 or side/2 + 1 words for a bf16 row inside the plane, one
//   word per entry in f32), and output word g (two bf16 or one f32 entry)
//   takes its entries from the group's lanes by shuffles.  The same code
//   serves rows inside the plane and rows clamped at its edges, without
//   branches.  A warp covers 32 / group rows per pass, the loads of four
//   passes in flight together.  Columns that are not a window (not made by
//   the lookups; other callers may pass them) are read entry by entry after
//   the windows.  A bf16 group is side/2 + 1 lanes, an f32 group `side`
//   lanes: in f32 a side above 16 leaves one row per pass, the slower
//   branch.
// - The run's outputs are one contiguous span of R * side^2 entries: they
//   are staged in shared memory and written with 16-byte stores, the ragged
//   end of the last run masked.  Each level's output starts 16-byte aligned
//   (the caller pads between levels), and R * side^2 entries are a multiple
//   of 16 bytes (R even in bf16), so every run's span is too.
// - At most 64 registers a thread (four blocks of 256 threads per SM): on
//   an H100 that was faster than 40 or 32 registers with more blocks (which
//   spill), and than eight passes' loads in flight.
// Offsets are 64-bit: a level-0 band volume at the tile (6 x 16 200 x 16 200
// entries, 1.57e9) is under 2^31 entries, but its byte offsets are not, and
// an untiled 'band' window (3 x 32 400^2 entries) passes 2^31 entries.
//
// Bounds guards (bounds.cuh, checked build), each level against its own
// tensors' extents, the outputs against each level's own span of the shared
// output buffer: every load of rr and cc; each window row's span of entries
// where its read plan is made, and each word load against that span; each
// entry read entry by entry; every store.  They are of the deferred form
// (a miss is noted, the thread traps at the kernel's end): with immediate
// traps among the word loop's shuffles, the compiler built a kernel that
// gave wrong entries on one ragged draw (bf16, side 2, a 3x5 plane), while
// each subset of the guards built right.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSide = 30;         // radius <= 14
constexpr int kWarps = 8;            // runs per block
constexpr int kMinBlocks = 4;        // blocks per SM the registers must allow
constexpr int kStageBytes = 2048;    // a run's staged outputs, at most (runs of 2 or more)
constexpr int kMaxRows = 256;        // patch rows of a run, at most
constexpr int kUnroll = 4;           // passes of one batch of loads

struct Levels {
  const void* vol[kMaxLevels];
  const int* rr[kMaxLevels];
  const int* cc[kMaxLevels];
  void* out[kMaxLevels];
  int64_t sb[kMaxLevels];
  int sq[kMaxLevels];
  int sr[kMaxLevels];
  int lh[kMaxLevels];
  int lw[kMaxLevels];
  // Elements of each level's volume, rr, cc and output (bounds guards).
  long long vol_extent[kMaxLevels];
  long long rr_extent[kMaxLevels];
  long long cc_extent[kMaxLevels];
  long long out_extent[kMaxLevels];
};

// U: uint16_t (bf16 entries, read as 4-byte words holding two) or uint32_t.
template <typename U>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) volume_patch_kernel(
    const __grid_constant__ Levels lv, int n_total, int nq, int side, int run,
    unsigned side_magic, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + warp) * run;
  if (n0 >= n_total) return;  // the whole warp
  TF_MISS_DECL;
  const int nqr = min(run, n_total - n0);
  const int nrows = nqr * side;
  const int ss = side * side;
  const int lh = lv.lh[l], lw = lv.lw[l];

  // Per warp: [stage: run * side^2 entries][word address per row][query
  // bases][read plan per row][cc][least column, lead and span per query]
  // [rows read entry by entry]
  unsigned char* base = smem + warp * warp_bytes;
  uint32_t* stage = reinterpret_cast<uint32_t*>(base);
  uintptr_t* s_addr = reinterpret_cast<uintptr_t*>(base + run * ss * (int)sizeof(U));
  int64_t* s_qbase = reinterpret_cast<int64_t*>(s_addr + run * side);
  unsigned* s_plan = reinterpret_cast<unsigned*>(s_qbase + run);
  int* s_cc = reinterpret_cast<int*>(s_plan + run * side);
  int* s_cmin = s_cc + run * side;
  int* s_lead = s_cmin + run;
  int* s_span = s_lead + run;
  int* s_scattered = s_span + run;
  const U* vol = static_cast<const U*>(lv.vol[l]);

  // The run's rr and cc, every load issued before the first is used.
  const int* rrl = lv.rr[l] + (int64_t)n0 * side;
  const int* ccl = lv.cc[l] + (int64_t)n0 * side;
  int rv[kMaxRows / 32], cv[kMaxRows / 32];
#pragma unroll
  for (int k = 0; k < kMaxRows / 32; ++k) {
    const int t = lane + 32 * k;
    if (t < nrows) {
      TF_NOTE_SPAN(rrl + t - lv.rr[l], 1, lv.rr_extent[l]);
      TF_NOTE_SPAN(ccl + t - lv.cc[l], 1, lv.cc_extent[l]);
      rv[k] = __ldg(rrl + t);
      cv[k] = __ldg(ccl + t);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxRows / 32; ++k)
    if (lane + 32 * k < nrows) s_cc[lane + 32 * k] = cv[k];
  __syncwarp();
  // Per query (one lane each): its base b*sb + q*sq (one division per run,
  // none per query) and the shape of its columns.  The caller clamps cc;
  // clamping again keeps a bad index from reading outside the volume.  A
  // window (2r+2 consecutive columns, clamped to the plane) is
  //   cc[j] = cmin + clamp(j - lead, 0, span - 1)
  // with `lead` the columns clamped at the left edge and `span` the
  // distinct columns; an unclamped window has lead 0 and span `side`.  Any
  // other columns (span 0) are read entry by entry.
  if (lane < nqr) {
    const int b0 = n0 / nq;
    int b = b0, q = n0 - b0 * nq + lane;
    while (q >= nq) {
      q -= nq;
      ++b;
    }
    s_qbase[lane] = b * lv.sb[l] + (int64_t)q * lv.sq[l];
    const int* c = s_cc + lane * side;
    int cmin = lw, cmax = -1, lead = -1;
    for (int j = 0; j < side; ++j) {
      const int cj = min(max(c[j], 0), lw - 1);
      cmin = min(cmin, cj);
      cmax = max(cmax, cj);
    }
    for (int j = 0; j < side && min(max(c[j], 0), lw - 1) == cmin; ++j) ++lead;
    const int span = cmax - cmin + 1;
    bool window = true;
    for (int j = 0; j < side; ++j)
      window &= min(max(c[j], 0), lw - 1) == cmin + min(max(j - lead, 0), span - 1);
    s_cmin[lane] = cmin;
    s_lead[lane] = lead;
    s_span[lane] = window ? span : 0;
  }
  __syncwarp();
  // Per row t = q * side + i (one lane each): the word address of its least
  // column and its plan: off (1 if that column is the high half of a bf16
  // word), lead, span and the words that hold the span, or 0 for a row
  // read entry by entry (listed, with the address of its column 0).  rr is
  // clamped again too.
  int nscattered = 0;
#pragma unroll
  for (int k = 0; k < kMaxRows / 32; ++k) {
    const int t = lane + 32 * k;
    bool scattered = false;
    if (t < nrows) {
      const int q = __umulhi((unsigned)t, side_magic);
      const int r = min(max(rv[k], 0), lh - 1);
      const U* row = vol + s_qbase[q] + (int64_t)r * lv.sr[l];
      const int span = s_span[q];
      const uintptr_t first = reinterpret_cast<uintptr_t>(row + s_cmin[q]);
      const unsigned off = sizeof(U) == 2 ? (unsigned)(first >> 1) & 1u : 0u;
      const unsigned nw = sizeof(U) == 2 ? (off + span + 1) >> 1 : span;
      TF_NOTE_SPAN_IF(span != 0, row + s_cmin[q] - vol, span, lv.vol_extent[l]);
      scattered = span == 0;
      s_addr[t] = scattered ? reinterpret_cast<uintptr_t>(row) : first & ~(uintptr_t)3;
      s_plan[t] = scattered ? 0u : off | (unsigned)s_lead[q] << 1 | (unsigned)span << 8 | nw << 16;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, scattered);
    if (scattered) s_scattered[nscattered + __popc(mask & ((1u << lane) - 1))] = t;
    nscattered += __popc(mask);
  }
  __syncwarp();

  // A group of lanes takes a row, lane g output word g of it (two bf16 or
  // one f32 entry).  Lane g reads word g of the aligned 4-byte words that
  // hold the row's columns (only words that hold one), and output word g
  // takes its entries from the group's lanes by shuffles: entry j of the
  // row sits at position p = clamp(j - lead, 0, span - 1) + off of the
  // words read.
  constexpr bool kPairs = sizeof(U) == 2;
  const int words = kPairs ? side / 2 : side;  // output words per row
  const int group = kPairs ? words + 1 : words;
  const int per_pass = 32 / group;
  const int grp = lane / group;
  const int g = lane - grp * group;
  const int t_lane = grp < per_pass ? grp : nrows;  // lanes past the last group idle
  for (int t0 = 0; t0 < nrows; t0 += per_pass * kUnroll) {
    unsigned plan[kUnroll];
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * per_pass + t_lane;
      plan[u] = t < nrows ? s_plan[t] : 0u;
      v[u] = 0;
      if ((int)(plan[u] >> 16) > g) {
        const uint32_t* word = reinterpret_cast<const uint32_t*>(s_addr[t]) + g;
        // The word holds entry positions [e, e + 4 / sizeof(U)) of the row's
        // plan, of which the span takes [off, off + span).
        TF_NOTE((word - reinterpret_cast<const uint32_t*>(s_addr[t])) * (4 / (int)sizeof(U)) <
                    (int)(plan[u] & 1) + (int)((plan[u] >> 8) & 255) &&
                (word - reinterpret_cast<const uint32_t*>(s_addr[t]) + 1) * (4 / (int)sizeof(U)) >
                    (int)(plan[u] & 1));
        v[u] = __ldg(word);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int off = plan[u] & 1;
      const int lead = (plan[u] >> 1) & 127;
      const int last = (int)((plan[u] >> 8) & 255) - 1;
      uint32_t out;
      if constexpr (kPairs) {
        const int p0 = min(max(2 * g - lead, 0), last) + off;
        const int p1 = min(max(2 * g + 1 - lead, 0), last) + off;
        const uint32_t x0 = __shfl_sync(0xffffffffu, v[u], lane - g + (p0 >> 1));
        const uint32_t x1 = __shfl_sync(0xffffffffu, v[u], lane - g + (p1 >> 1));
        out = __byte_perm(x0, x1, ((p0 & 1) ? 0x32u : 0x10u) | ((p1 & 1) ? 0x7600u : 0x5400u));
      } else {
        out = __shfl_sync(0xffffffffu, v[u], lane - g + min(max(g - lead, 0), last));
      }
      if (plan[u] != 0 && g < words) stage[(t0 + u * per_pass + t_lane) * words + g] = out;
    }
  }
  // Rows read entry by entry: every load of a batch of entries issued
  // before the batch is staged.
  U* stage_entries = reinterpret_cast<U*>(stage);
  for (int e0 = 0; e0 < nscattered * side; e0 += 32 * kUnroll) {
    U val[kUnroll];
    int dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + 32 * u + lane;
      dst[u] = -1;
      if (e < nscattered * side) {
        const int k = __umulhi((unsigned)e, side_magic);
        const int j = e - k * side;
        const int t = s_scattered[k];
        const int c = s_cc[__umulhi((unsigned)t, side_magic) * side + j];
        dst[u] = t * side + j;
        TF_NOTE_SPAN(reinterpret_cast<const U*>(s_addr[t]) + min(max(c, 0), lw - 1) - vol, 1,
                     lv.vol_extent[l]);
        val[u] = __ldg(reinterpret_cast<const U*>(s_addr[t]) + min(max(c, 0), lw - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (dst[u] >= 0) stage_entries[dst[u]] = val[u];
  }
  __syncwarp();

  // The run's span: 16-byte stores, then the words of a ragged end.
  const int nwords = nrows * words;
  uint32_t* out = static_cast<uint32_t*>(lv.out[l]) + (int64_t)n0 * ss * (int)sizeof(U) / 4;
  const int n16 = nwords >> 2;
  for (int k = lane; k < n16; k += 32) {
    TF_NOTE_SPAN(reinterpret_cast<const U*>(reinterpret_cast<uint4*>(out) + k) -
                      static_cast<const U*>(lv.out[l]),
                 16 / (int)sizeof(U), lv.out_extent[l]);
    reinterpret_cast<uint4*>(out)[k] = reinterpret_cast<const uint4*>(stage)[k];
  }
  for (int k = 4 * n16 + lane; k < nwords; k += 32) {
    TF_NOTE_SPAN(reinterpret_cast<const U*>(out + k) - static_cast<const U*>(lv.out[l]),
                 4 / (int)sizeof(U), lv.out_extent[l]);
    out[k] = stage[k];
  }
  TF_TRAP_IF_MISSED();
}

}  // namespace

// elem_bytes: 2 (bf16) or 4 (f32); entries are copied, never interpreted.
// Host arrays of n_levels entries: vols, rrs, ccs (each [n_total, side]
// int32 with n_total = B * nq), outs (each [n_total, side, side], 16-byte
// aligned), lh, lw and the strides sb, sq, sr in elements (sq and sr below
// 2^31), and the elements of each level's tensors, extents[4 * l + i] for
// i = volume, rr, cc, output (read by the checked build only).  side is
// even, 2..30.  Returns the launch's cudaError_t.
extern "C" int tf_volume_patch(int elem_bytes, int n_levels, const void* const* vols,
                               const int* const* rrs, const int* const* ccs, void* const* outs,
                               const int* lh, const int* lw, const long long* sb,
                               const long long* sq, const long long* sr,
                               const long long* extents, long long n_total, int nq, int side,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_total < 1 || nq < 1 || n_total % nq != 0 ||
      side < 2 || side > kMaxSide || side % 2 != 0 || n_total * side > 0x7fffffffLL ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    if (lh[l] < 1 || lw[l] < 1 || sq[l] < 0 || sq[l] > 0x7fffffffLL || sr[l] < 0 ||
        sr[l] > 0x7fffffffLL || sb[l] < 0 || reinterpret_cast<uintptr_t>(outs[l]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    lv.vol[l] = vols[l];
    lv.rr[l] = rrs[l];
    lv.cc[l] = ccs[l];
    lv.out[l] = outs[l];
    lv.sb[l] = sb[l];
    lv.sq[l] = (int)sq[l];
    lv.sr[l] = (int)sr[l];
    lv.lh[l] = lh[l];
    lv.lw[l] = lw[l];
    lv.vol_extent[l] = extents[4 * l];
    lv.rr_extent[l] = extents[4 * l + 1];
    lv.cc_extent[l] = extents[4 * l + 2];
    lv.out_extent[l] = extents[4 * l + 3];
  }
  // Queries per run: as many as the stage holds, at most 32 and kMaxRows /
  // side, at least 2, even in bf16 so that every run's span is a multiple
  // of 16 bytes.
  const int qbytes = side * side * elem_bytes;
  int run = kStageBytes / qbytes;
  if (run > kMaxRows / side) run = kMaxRows / side;
  if (run > 32) run = 32;
  if (run < 2) run = 2;  // side > 22 in bf16, > 16 in f32: a larger stage
  if (elem_bytes == 2) run &= ~1;
  // Per row: address, plan, cc, listed; per query: base, cmin, lead, span.
  const int index_bytes = run * side * 20 + run * 20;
  const int warp_bytes = run * qbytes + (index_bytes + 15) / 16 * 16;
  const int smem = kWarps * warp_bytes;
  const long long runs = (n_total + run - 1) / run;
  const dim3 grid((unsigned)((runs + kWarps - 1) / kWarps), (unsigned)n_levels);
  const unsigned magic = 0xffffffffu / (unsigned)side + 1u;  // ceil(2^32 / side)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          volume_patch_kernel<uint16_t>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    volume_patch_kernel<uint16_t><<<grid, 32 * kWarps, smem, s>>>(
        lv, (int)n_total, nq, side, run, magic, warp_bytes);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          volume_patch_kernel<uint32_t>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    volume_patch_kernel<uint32_t><<<grid, 32 * kWarps, smem, s>>>(
        lv, (int)n_total, nq, side, run, magic, warp_bytes);
  }
  return (int)cudaGetLastError();
}
