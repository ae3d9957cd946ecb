#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpuflow_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result lines); the MOF/Twins phases 4-10 share one engine:

1. environment: a CUDA device is required; prints nvidia-smi's name and
   power limit.
2. build: every CUDA kernel from tpuflow_torch/csrc, one nvcc per source,
   all started together; K2's SASS must hold wgmma and TMA instructions,
   K3/K5's tensor-core ones.
3. kernels: each kernel against its plain PyTorch version at the shapes
   its path gives it, with its time, its plain version's time, its bound on
   the card and, where one exists, one PyTorch call's time.  K1 and K2 at
   the tiled path (two 960x1080 tiles, /8 grid 135x120, 6 batch rows per
   window), K1 also as the 'flash' sidecar there and K2 also at the untiled
   window's [3, 32400, 128] and a MemFlow frame's [1, 32400, 128]; the
   correlation-patch kernel (K3 and K5) at the untiled 1920x1080 window (3 x
   135x240 queries, C = 256) on independent, smooth, small and mixed flow
   fields, with the share of query tiles that take its tensor-core path, K3
   also at a MemFlow frame's 1 x 135x240 queries, K5 also at level 0 of the
   tile shape, both against an f32 reference; the
   volume-patch kernel (K4 flat layout, K6 band layout) bit for bit through
   its one-level and its all-levels entry, at radius 0, 1, 4 and 14 with
   patches across every plane edge, at the tile shape (timed on the device
   and on the host clock), and on a 4.5 GB level read beyond element 2^31;
   each also on ragged shapes.  For spatial sharding: K1 from a row0 > 0
   (a strip of the tile's grid, a ragged last strip, and ragged strips
   across every plane edge), K2 with query and key counts that differ (one
   strip of the untiled window, [3, 8160, 128] queries against [3, 32400,
   128] keys, timed; ragged pairs).  K7 (PCBlock4's depthwise stages, no
   TPU kernel) at MemFlow's 1080p stages and two of MOF's tile stages in
   bf16 with the pointwise entry folded in, timed beside its bound (bytes,
   or operations at the tensor cores' rate), its plain twin and the
   module's former cuDNN composition, and on ragged shapes in bf16 and f32.
   K8 (PCBlock4's 1x1 convs, no TPU kernel) at every (M, K, N, residual,
   GELU) of both cells' SK blocks in bf16, timed beside its bound, its
   plain twin and F.linear with the add and the GELU, and on ragged shapes
   (tails of every tile, 8- to 1-element copies, unaligned and strided
   rows) in bf16 and f32.
   K9 (MemFlow's memory reader, no TPU kernel) at the 1080p grid with 8
   slots: its f32 readout against the plain twin (TF32 off) on four
   validity patterns (a planted one, non-contiguous, all, none), within
   1e-4 of the readout's largest entry and 99 % of the bf16 readout
   bit-equal; ragged grids (640x480 and B = 2 among them); timed at 8 and
   4 valid slots beside its f32 FMA bound, its twin and one masked
   F.scaled_dot_product_attention call in f32.
4. end to end, tiled: FlowEngine.compute_flows_tiled_stride1 on six
   synthetic 1920x1080 frames at the full configuration (Twins-SVT, 4
   levels, radius 4, 12 iterations, T=5, bf16, seeded random weights).  The
   kernels' launch counters are zeroed just before and read just after.
5. end to end, untiled: one 1920x1080 window through FlowEngine.compute_flow
   with corr_impl='auto' (FlashCorr2, kernel K3; counters as above; K3's
   device time in the profile of one refinement), then the same window
   with corr_impl='dense', and the two flows compared.
6. multi-window, untiled: compute_flows_strided on seven 1920x1080 frames
   with window_batch=2 and compute_flow_batch with two windows; the middle
   interior frame of a strided window against compute_flow.
7. formulations: corr_impl 'flash' (K5 + K1 sidecar), 'band' (K6) and
   dense_lookup='patch' (K4) through MOFNet at the tile shape with 2
   iterations, each against corr_impl='dense' at the same depth, with
   launch counters, timed as the median of 3 calls after a warm-up; one
   'patch' and one 'band' lookup profiled by part (geometry, kernel,
   epilogue, concat).
8. window batching: compute_flows_tiled_stride1 on four 1920x1080 frames
   with window_batch 1, 2 and 8 (clamped to what the card's free memory
   holds), the flows held to each other.
9. 4K: one 3840x2160 frame through compute_flow_tiled with tile_batch 4 (six
   1080x1280 tiles in chunks of 4 and 2) and 6, held to each other.
10. single tile: a 640x480 clip through compute_flow_tiled and
   compute_flows_tiled_stride1 equals compute_flow bit for bit.
11. BOF (architecture 'bof', T=3): tiled stride-1 on six 1920x1080 frames and
   one untiled window (K3), then every entry point on a small clip; the cnn
   encoder (encoder 'cnn'): tiled stride-1 on four 1920x1080 frames, its
   encoders' time per frame against Twins's and their profile, then every
   entry point on a small clip.
12. MemFlow (model 'memflow', rope on, a memory of 8 slots): stream_flows on
   ten 1920x1080 frames (K3 48, K2 12, K7 72 and K9 1 launches per frame, K1 none; every
   slot valid after the clip), one frame's encoders, memory reader and
   refinement timed and the refinement profiled, the memory reader against
   a plain readout of the valid slots, every entry point against
   compute_flow bit for bit, and a 640x480 stream (K1 12 per frame).
13. parity: one small clip through the same engine weights in f32 with TF32
   off, on the CPU (plain versions) and on the card (kernels): tiled, one
   untiled window above the materialization threshold (FlashCorr2), and
   MemFlow's stream_flows with both of its gates lowered (K3 and K2).
14. pipeline: the video pipeline and its CLI (tpuflow_torch.tools.cli.main in
   this process) on a synthetic 6-frame 1920x1080 clip written uncompressed:
   --tile, the default untiled route (--batch-frames 4) and --model memflow,
   each with --taa --save-flow both, counters zeroed before and read after
   each run; every cached flow bit-equal to a direct engine call on the same
   frames, its .flo bytes equal to FlowFileHandler's and the native
   cacheio's, its LODs equal to LODGenerator's (ops.generate_lods on the
   card within 1e-6), each output video of the mode's size; the --tile
   cache re-rendered once per --flow-format and once with --flow-input (no
   launch), the render's device work against the same ops on the CPU; the
   stages' host times, the render's device time per frame (CUDA events) and
   each route's peak memory; and `python3 -m tpuflow_torch.tools.cli
   --show-tiles` with jax and the JAX package blocked.
15. correction: the CLI's --interactive --tile on a fresh 3-frame 1920x1080
   clip, without a display and under torch's default TF32 flags: it computes
   the flows (K1 24 and K2 12 launches per window, counters zeroed before
   and read after), audits the LODs, builds tools/visualizer.FlowInspector
   on the card and returns 1 with the cache statistics; then on the card,
   over that cache: the quality and turbulence maps, analyze_pixel,
   detail_analysis and consistency_check (consistent) at two bad pixels,
   correct_range over every frame at the JAX package's defaults (65536
   pixels at most, region 50, template radius 11, search radius 50) with
   each pass's pixels, device and host time and each frame's peak memory,
   one frame's correction (4096 pixels) traced with device_trace; the
   NCC against cv2.matchTemplate (one channel) and a float64 numpy
   reference (three) at full size, phase correlation and the coarse pass on
   a known 1080p translation, and both passes on the card against the CPU
   on 512 bad pixels where their peaks are clear.
16. data parallel: FlowEngine(mesh=) over a Mesh listing the card twice
   (on a one-card host; PipelineConfig(data_parallel=2) builds no
   mesh on one card) at the product configuration on the main engine's
   weights: compute_flows_tiled_stride1 on six 1080p frames with
   window_batch 2, bit for bit the one-replica engine; compute_flow_batch
   on three untiled 1080p windows padded to four (K3 and K2 per replica);
   compute_flows_strided on seven frames, bit for bit the one-replica
   window_batch 1; frames/s, peak memory and launches (two replicas on one
   card show correctness, not a speed-up).
16b. spatial: shard_spatial_forward (one frame's height over the mesh's
   'spatial' slots, a host thread per slot) on the main engine's weights
   over meshes that list the card several times: ('data' 1, 'spatial' 4)
   on one untiled 1080p window (strips of 34, 34, 34, 33 feature rows;
   'auto' decided on the whole grid: K3 384 and K2 48 launches) against
   compute_flow, and ('data' 2, 'spatial' 2) on two 640x480 windows (K1
   from row0 0 and 30: 96 launches) against compute_flow_batch, each
   within the flow limits, with its wall, the card's peak memory and the
   bytes the strips fetched from each other; then K1 from each strip's
   row0 on the model's own volumes, bit for bit the unsharded rows, and K2
   from each strip's queries to the frame's keys against the unsharded
   rows.
17. checkpoint: save_params of the main engine's weights and load_model of
   the native file into a fresh engine, weights and flows bit for bit; the
   converter `python3 -m tpuflow_torch.runtime.checkpoint` on a .pth.
18. distributed: two CLI processes (--num-processes 2, gloo, both on the
   card) --tile on a 6-frame 1920x1080 clip, against one process's pass on
   a copy, and --model memflow on 8 frames of 640x480, bit for bit (the
   warm-up prefix reaches frame 0); each process's wall.
19. train: shard_train_step over two replicas on the card, the product
   configuration at 368x496 in f32 (dense_lookup='xla', gma_impl='xla',
   AdamW), three steps under torch's default TF32 flags (ms per step,
   peak memory; K7 forward, its plain twin backward, 6 launches a step and
   replica); K1 and K2 refuse a backward; one narrow step card against
   CPU with TF32 off.
20. checked build, in a child process started before phase 2 (this script
   with --checked-build, run only by the script itself): every kernel built
   with its bounds guards (kernels/_build.py, checked=True), each of the nine
   wrappers on its ragged and plane-edge shapes of phase 3; a guard's trap
   poisons the child's CUDA context and its non-zero exit fails the run.

Output: progress lines, then one JSON line with every kernel's numbers, the
card's name and power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bounds below
# are the least time the card could take at these rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

MAIN_FRAMES = 6
MAIN_H, MAIN_W = 1080, 1920
FORMULATION_DEPTH = 2             # iterations of the 'flash' / 'band' / 'patch' runs
UNTILED_QUERIES = (3, 135, 240)   # interior frames x the /8 grid of one 1920x1080 window
TILE_QUERIES = (6, 135, 120)      # 2 tiles x 3 interior frames x the /8 grid of a 960x1080 tile
FEATURE_DIM = 256
# K2's bf16 ragged key counts: partial and whole 128-row tiles around 1 and 2.
K2_RAGGED_S = (1, 63, 64, 65, 127, 128, 129, 200)
STRIP_ROWS = 34                   # /8 rows of the first strips of 135 over four 'spatial' slots
PARITY_SHAPE = (5, 128, 256)      # frames, H, W: two 128x128 tiles at tile_size 128
# Two bf16 runs of one window that round differently (another formulation,
# another batch size) are held to these shares of the mean |flow|.  Sound
# runs read 5.2e-4 to 1.3e-3 (mean) and 3.5e-3 to 8.9e-3 (max) on an H100.
FLOW_MEAN_LIMIT = 5e-3
FLOW_MAX_LIMIT = 3e-2
# Lookup features of two formulations at the same flows, per level, as shares
# of the level's largest and mean |feature| (see check_lookups_agree).  Sound
# runs read 1.0e-2 to 1.3e-2 (max) and 2.7e-3 to 2.9e-3 (mean) on an H100;
# a misplaced window axis or level differs by the features' own size.
LOOKUP_MAX_LIMIT = 2**-5
LOOKUP_MEAN_LIMIT = 2**-7
SEED = 0


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Median device time of one call, from CUDA events around each call.
    queued: the card first sleeps while the host enqueues every call, so
    that a call shorter than its own launch cost on the host is timed on the
    device alone, not with the host's gaps between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(200_000_000)        # ~0.1 s at the H100's clocks
    events = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; this script runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("card:", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    # f32 comparisons below are made without TF32 on either path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    import importlib.util
    import shutil
    from pathlib import Path

    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(str(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    for cand in cands:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found (CUDA toolkit or triton/backends/nvidia/bin)")


def sass_counts(library, opcodes) -> dict:
    """How many instructions of each opcode the library's SASS holds."""
    import re

    sass = subprocess.run([find_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def phase_build() -> None:
    from tpuflow_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line or "arning" in line:
                log(f"  {name}: {line.strip()}")
    # K2's bf16 kernel must be built from wgmma (HGMMA) fed by TMA
    # (UTMALDG): a design that fell back to mma.sync has neither.
    counts = sass_counts(_build.library_path("flash_attention"), ("HGMMA", "UTMALDG"))
    log(f"  flash_attention SASS: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"flash_attention is not built from wgmma and TMA: {counts}")
    # K3/K5's tile kernel must run its products on the tensor cores (HMMA
    # from mma.sync, or HGMMA).
    counts = sass_counts(_build.library_path("corr_patch"), ("HMMA", "HGMMA"))
    log(f"  corr_patch SASS: {counts}")
    if not any(counts.values()):
        raise AssertionError(f"corr_patch holds no tensor-core instruction: {counts}")
    # K8's bf16 kernel must run its products as wgmma (HGMMA).
    counts = sass_counts(_build.library_path("pointwise_gemm"), ("HGMMA",))
    log(f"  pointwise_gemm SASS: {counts}")
    if not counts["HGMMA"]:
        raise AssertionError(f"pointwise_gemm is not built from wgmma: {counts}")


def random_volumes(g, dev, n, h, w, levels, dtype):
    vols, lh, lw = [], h, w
    for _ in range(levels):
        vols.append(torch.randn((n, lh, lw), generator=g, device=dev).to(dtype))
        lh, lw = lh // 2, lw // 2
    return vols


def window_edges(flow, r: int, dims, offset: int, row0: int = 0) -> list:
    """For each level (lh, lw) of `dims` sampled at 2^(l + offset): whether
    some query's (2r+2)^2 patch straddles the plane's left, right, top and
    bottom edge (the query grid's rows at image rows row0 ..)."""
    b, h, w, _ = flow.shape
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + h, device=flow.device, dtype=torch.float32),
                            torch.arange(w, device=flow.device, dtype=torch.float32), indexing="ij")
    bx, by = xs + flow[..., 0], ys + flow[..., 1]
    side = 2 * r + 2
    out = []
    for lvl, (lh, lw) in enumerate(dims):
        x0 = torch.floor(bx / 2 ** (lvl + offset)) - r
        y0 = torch.floor(by / 2 ** (lvl + offset)) - r
        out.append([bool(((lo < edge) & (lo + side > edge)).any()) for lo, edge in
                    ((x0, 0), (x0, lw), (y0, 0), (y0, lh))])
    return out


def check_dense_lookup_ragged(g, dev) -> None:
    """K1 on ragged shapes: radius 0 to 4, 1 to 6 levels, with and without
    level_offset, odd plane widths, 198 queries (no power-of-two block
    divides them) or 10 050; flows of up to 1.5x the grid put patches across
    each edge of each level's plane (asserted) and wholly off it."""
    from tpuflow_torch.kernels.denselookup import dense_lookup, dense_lookup_plain

    for (b, h, w), levels, r, dtype, off in (((2, 9, 11), 4, 0, torch.float32, 0),
                                             ((2, 9, 11), 3, 1, torch.bfloat16, 1),
                                             ((2, 9, 11), 3, 2, torch.float32, 0),
                                             ((2, 9, 11), 2, 3, torch.bfloat16, 1),
                                             ((2, 9, 11), 4, 4, torch.bfloat16, 0),
                                             ((2, 9, 11), 1, 4, torch.float32, 2),
                                             ((2, 67, 75), 6, 3, torch.bfloat16, 0)):
        vols = random_volumes(g, dev, b * h * w, h >> off, w >> off, levels, dtype)
        flow = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * torch.tensor(
            [1.5 * w, 1.5 * h], device=dev)
        edges = window_edges(flow, r, [v.shape[1:] for v in vols], off)
        if not all(all(e) for e in edges):
            raise AssertionError(f"K1 ragged draw leaves a plane edge unstraddled: {edges}")
        err = (dense_lookup(vols, flow, r, off) - dense_lookup_plain(vols, flow, r, off)).abs().max().item()
        log(f"K1 ragged {b}x{h}x{w} L={levels} r={r} offset={off} {dtype} planes "
            f"{[tuple(v.shape[1:]) for v in vols]}: max |kernel - plain| = {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"K1 disagrees with its plain version on a ragged shape: {err}")
    # Row strips of a frame (row0 > 0): queries of h rows from image row
    # row0 against planes of the whole frame's hf rows.
    for (b, h, w), hf, row0, levels, r, dtype in (((2, 7, 11), 19, 12, 3, 3, torch.bfloat16),
                                                  ((1, 5, 9), 17, 6, 2, 1, torch.float32),
                                                  ((3, 3, 13), 9, 3, 4, 4, torch.bfloat16)):
        vols = random_volumes(g, dev, b * h * w, hf, w, levels, dtype)
        flow = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * torch.tensor(
            [1.5 * w, 1.5 * hf], device=dev)
        edges = window_edges(flow, r, [v.shape[1:] for v in vols], 0, row0)
        if not all(all(e) for e in edges):
            raise AssertionError(f"K1 strip draw leaves a plane edge unstraddled: {edges}")
        err = strip_lookup_error(vols, flow, r, row0)
        log(f"K1 ragged strip {b}x{h}x{w} rows {row0}..{row0 + h} of {hf} L={levels} r={r} {dtype}: "
            f"max |kernel - plain| = {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"K1 disagrees with its plain version on a strip (row0 {row0}): {err}")


def strip_lookup_error(vols, flow, r: int, row0: int) -> float:
    """max |K1 - plain| at row0, after checking that row0 moves the plain
    lookup (so a kernel that ignored it could not agree)."""
    from tpuflow_torch.kernels.denselookup import dense_lookup, dense_lookup_plain

    ref = dense_lookup_plain(vols, flow, r, row0=row0)
    if torch.equal(ref, dense_lookup_plain(vols, flow, r)):
        raise AssertionError(f"row0 {row0} does not move the plain lookup on this draw")
    return (dense_lookup(vols, flow, r, row0=row0) - ref).abs().max().item()


def check_dense_lookup(dev) -> dict:
    """K1 on ragged shapes (check_dense_lookup_ragged), then at the main path:
    4 levels of bf16 volumes for 6 x 135 x 120 queries, radius 4, flows of
    +-40 px."""
    from tpuflow_torch.kernels.denselookup import dense_lookup, dense_lookup_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    check_dense_lookup_ragged(g, dev)

    (b, h, w), levels, r = TILE_QUERIES, 4, 4
    vols = random_volumes(g, dev, b * h * w, h, w, levels, torch.bfloat16)
    flow = (torch.rand((b, h, w, 2), generator=g, device=dev) * 80.0 - 40.0).contiguous()

    got = dense_lookup(vols, flow, r)
    ref = dense_lookup_plain(vols, flow, r)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    log(f"K1 dense_lookup {tuple(got.shape)}: max |kernel - plain| = {err:.3e}")
    # Same f32 operations in the same order (the kernel's are explicitly
    # rounded, never fused into FMAs) on the same bf16 taps.
    if not math.isfinite(err) or err > 1e-5:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")

    # The 'flash' path's sidecar at the same queries: levels 1-3 of the
    # pyramid stored alone and sampled at 2^(l+1).
    side_vols = random_volumes(g, dev, b * h * w, h // 2, w // 2, 3, torch.bfloat16)
    side_err = (dense_lookup(side_vols, flow, r, 1) - dense_lookup_plain(side_vols, flow, r, 1)).abs().max().item()
    log(f"K1 dense_lookup sidecar, 3 levels from {h // 2}x{w // 2}, offset 1: max |kernel - plain| = {side_err:.3e}")
    if not side_err <= 1e-5:
        raise AssertionError(f"K1 with level_offset=1 disagrees with its plain version: {side_err}")
    del side_vols

    # One row strip of the tile's grid (spatial sharding over four slots:
    # the second strip's 34 of 135 rows) against the whole tile's planes,
    # and a ragged strip (the last one, 33 rows from row 102).
    strip_errs = {}
    for rows, row0 in ((34, 34), (33, 102)):
        svols = random_volumes(g, dev, b * rows * w, h, w, levels, torch.bfloat16)
        sflow = (torch.rand((b, rows, w, 2), generator=g, device=dev) * 80.0 - 40.0).contiguous()
        serr = strip_lookup_error(svols, sflow, r, row0)
        log(f"K1 dense_lookup strip {b}x{rows}x{w} from row {row0} of {h}: max |kernel - plain| = {serr:.3e}")
        if not serr <= 1e-5:
            raise AssertionError(f"K1 with row0={row0} disagrees with its plain version: {serr}")
        strip_errs[f"rows_{row0}_{row0 + rows}"] = serr
        del svols

    # Least bytes for this run's data: the in-plane taps of every query's
    # (2r+2)^2 patch at every level, the flow, and the f32 output.
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32), indexing="ij",
    )
    bx, by = xs + flow[..., 0], ys + flow[..., 1]
    side = 2 * r + 2
    nbytes = flow.numel() * 4 + got.numel() * 4
    for lvl, vol in enumerate(vols):
        lh, lw = vol.shape[1:]
        x0 = torch.floor(bx / 2**lvl) - r
        y0 = torch.floor(by / 2**lvl) - r
        cols = ((x0 + side).clamp(max=lw) - x0.clamp(min=0)).clamp(min=0)
        rows = ((y0 + side).clamp(max=lh) - y0.clamp(min=0)).clamp(min=0)
        nbytes += int((cols * rows).sum().item()) * vol.element_size()
    flops = got.numel() * 9                 # three lerps of sub, mul, add
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    ms = time_ms(lambda: dense_lookup(vols, flow, r), reps=20)
    plain_ms = time_ms(lambda: dense_lookup_plain(vols, flow, r), reps=5)

    # Yardstick, never used by the port: upstream VideoFlow's lookup, one
    # F.grid_sample per level (bilinear, zero padding, align_corners) plus
    # the x-major transpose and concat.  grid_sample takes its input and grid
    # in one dtype and a bf16 grid would misplace taps by up to half a
    # pixel, so it reads exact f32 copies of the bf16 volumes.
    import torch.nn.functional as F

    vols32 = [v.float().view(-1, 1, *v.shape[1:]) for v in vols]
    delta = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    dy, dx = torch.meshgrid(delta, delta, indexing="ij")

    def grid_sample_lookup():
        out = []
        for lvl, vol in enumerate(vols32):
            lh, lw = vol.shape[2:]
            gx = (bx / 2**lvl).reshape(-1, 1, 1) + dx
            gy = (by / 2**lvl).reshape(-1, 1, 1) + dy
            grid = torch.stack((2 * gx / (lw - 1) - 1, 2 * gy / (lh - 1) - 1), dim=-1)
            s = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
            out.append(s.reshape(b, h, w, side - 1, side - 1).transpose(-1, -2).reshape(b, h, w, -1))
        return torch.cat(out, dim=-1)

    lib_err = (grid_sample_lookup() - got).abs().max().item()
    library_ms = time_ms(grid_sample_lookup, reps=5)
    del vols32
    log(f"K1 ms {ms:.4f}  plain {plain_ms:.4f}  grid_sample {library_ms:.4f} (max |grid_sample - kernel| "
        f"= {lib_err:.3e})  bound {bound:.4f} ({nbytes / 1e6:.1f} MB)")
    # The same function up to grid_sample's own coordinate arithmetic.
    if not lib_err <= 1e-3:
        raise AssertionError(f"grid_sample yardstick computes another function: {lib_err}")
    return {
        "name": "dense_lookup", "route": "cuda",
        "source": "tpuflow_torch/csrc/dense_lookup.cu",
        "replaces": "tpuflow/kernels/denselookup.py:398",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations",
        "library_ms": library_ms, "strip_max_abs_err": strip_errs,
    }


def check_flash_attention(dev) -> dict:
    """K2 on ragged shapes, then at the shapes its paths give it, q, k, v
    bf16 with q pre-scaled by 128^-0.5 as Attention emits it: the tiled
    window's [6, 16200, 128] (127 query tiles and 127 key tiles of 128, the
    last of 72 rows), the untiled window's [3, 32400, 128] (254 of each,
    the last of 16), a MemFlow 1080p frame's [1, 32400, 128], and one row
    strip of the untiled window under spatial sharding over four slots
    (three interior frames x 34 x 240 = [3, 8160, 128] queries against the
    frame's [3, 32400, 128] keys)."""
    qkv = qkv_draws(dev)
    check_flash_attention_ragged(qkv)

    tiled = flash_attention_at(qkv, TILE_QUERIES[0], TILE_QUERIES[1] * TILE_QUERIES[2])
    untiled = flash_attention_at(qkv, UNTILED_QUERIES[0], UNTILED_QUERIES[1] * UNTILED_QUERIES[2])
    memflow = flash_attention_at(qkv, 1, UNTILED_QUERIES[1] * UNTILED_QUERIES[2])
    strip = flash_attention_at(qkv, UNTILED_QUERIES[0], STRIP_ROWS * UNTILED_QUERIES[2],
                               UNTILED_QUERIES[1] * UNTILED_QUERIES[2])
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "tpuflow_torch/csrc/flash_attention.cu",
        "replaces": "tpuflow/core/gma.py:35",
        **tiled, "at_untiled_window": untiled, "at_memflow_frame": memflow, "at_strip": strip,
    }


def qkv_draws(dev):
    """qkv(b, s, dtype, sk=s): seeded q [b, s, 128], pre-scaled by
    128^-0.5, and k, v [b, sk, 128]."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def qkv(b, s, dtype, sk=None):
        d = 128
        q = (torch.randn((b, s, d), generator=g, device=dev) * d**-0.5).to(dtype)
        return q, *(torch.randn((b, sk or s, d), generator=g, device=dev).to(dtype) for _ in range(2))

    return qkv


def check_flash_attention_ragged(qkv) -> None:
    """K2 on ragged shapes: the f32 FMA kernel on ragged key counts, within
    1e-4 + 1e-4|ref| (exact exponentials, f32 sums in another order); the
    bf16 kernel at B = 3 on partial query and key tiles of its 128-row CTA, S
    below one tile and tiles that end at a batch row's edge (the 3-D tensor
    map zero-fills past S instead of reading the next row); both with query
    and key counts that differ (the K2_RAGGED_S pairs, first against last)."""
    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain

    for b, s, sk in ((1, 130, 130), (3, 37, 37), (3, 37, 130), (2, 130, 37)):
        q, k, v = qkv(b, s, torch.float32, sk)
        got, ref = flash_attention_fwd(q, k, v), flash_attention_plain(q, k, v)
        excess = ((got - ref).abs() - 1e-4 * (1 + ref.abs())).max().item()
        log(f"K2 ragged [{b},{s},128] x [{b},{sk},128] f32: max |kernel - plain| = "
            f"{(got - ref).abs().max().item():.3e}")
        if not excess <= 0:
            raise AssertionError(f"K2 (f32) disagrees with its plain version at Sq={s}, Sk={sk}")
    for s in K2_RAGGED_S:
        flash_attention_draws(qkv, 3, s)
    for s, sk in zip(K2_RAGGED_S, reversed(K2_RAGGED_S)):
        flash_attention_draws(qkv, 3, s, sk)


def flash_attention_draws(qkv, b: int, s: int, sk: Optional[int] = None):
    """K2 at q [b, s, 128] and k, v [b, sk (default s), 128] bf16 against
    its plain version (chunked over queries) and an f32 reference, two
    draws.  Returns (max |kernel - plain|, the last draw's q, k, v)."""
    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain

    # At the model's scale (logits N(0, 1) over s keys) the softmax is nearly
    # uniform and outputs are ~0.01; with a logit spread of 4 (q scaled up) a
    # few keys dominate and outputs are O(0.3).  Each draw is held to an f32
    # reference `exact`:
    # - elementwise, against the rounding bound.  Both the kernel and the
    #   plain version round each probability (relative 2^-8, bf16's unit
    #   roundoff) and the output (2^-8 |out|) to bf16, so each errs by at
    #   most 2^-7 * scale with scale = softmax(q k^T) |v|, and the two differ
    #   by at most 2^-6 * scale;
    # - by norm: the kernel no worse than the plain bf16 version by more
    #   than a quarter.  A dropped or doubled 128-key tile moves the output by
    #   about sqrt(128 / s) (9e-2 at 16200 keys, 6e-2 at 32400) of its norm
    #   even at the model's scale.
    d = 128
    err = 0.0
    for name, logit_std in (("model scale", 1.0), ("peaked", 4.0)):
        q, k, v = qkv(b, s, torch.bfloat16, sk)
        q = (q.float() * logit_std).to(torch.bfloat16)
        got = flash_attention_fwd(q, k, v).float()
        ref = flash_attention_plain(q, k, v).float()
        exact = flash_attention_plain(q.float(), k.float(), v.float())
        scale = flash_attention_plain(q.float(), k.float(), v.float().abs())
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        err = max(err, diff.max().item())
        ratio_plain = (diff / (1e-5 + scale)).max().item()
        ratio_exact = ((got - exact).abs() / (1e-5 + scale)).max().item()
        rel_kernel = ((got - exact).norm() / exact.norm()).item()
        rel_plain = ((ref - exact).norm() / exact.norm()).item()
        log(f"K2 flash_attention_fwd {tuple(got.shape)} x {tuple(k.shape)} {name}: |out| rms {exact.pow(2).mean().sqrt().item():.3e}, "
            f"max |kernel - plain| = {diff.max().item():.3e} = {ratio_plain:.3e} scale, "
            f"max |kernel - f32| = {ratio_exact:.3e} scale, by norm vs f32: kernel {rel_kernel:.3e} "
            f"plain {rel_plain:.3e}")
        if not (ratio_exact <= 2**-7 and ratio_plain <= 2**-6 and rel_kernel <= 1.25 * rel_plain + 1e-4):
            raise AssertionError(f"K2 disagrees with its plain version at [{b},{s},{d}] x {tuple(k.shape)} ({name}): "
                                 f"{diff.max().item()}, by norm {rel_kernel} vs plain {rel_plain}")
    return err, q, k, v


def flash_attention_at(qkv, b: int, s: int, sk: Optional[int] = None) -> dict:
    """K2 at q [b, s, 128], k, v [b, sk (default s), 128] bf16: both draws,
    then its times and bound."""
    import torch.nn.functional as F

    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain

    d = 128
    sk = sk or s
    err, q, k, v = flash_attention_draws(qkv, b, s, sk)
    torch.cuda.empty_cache()
    flops = 4.0 * b * s * sk * d
    nbytes = 2 * b * (s + sk) * d * 2
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(lambda: flash_attention_fwd(q, k, v), reps=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), reps=5)
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=1.0),
        reps=20,
    )
    log(f"K2 [{b},{s},{d}] x [{b},{sk},{d}] ms {ms:.4f}  plain {plain_ms:.4f}  sdpa {lib_ms:.4f}  "
        f"bound {bound:.4f} ({flops / 1e9:.0f} GFLOP)")
    return {
        "shape": [b, s, d], "key_shape": [b, sk, d], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": lib_ms,
    }


def patch_geometry(flow, lvl, lh, lw, r):
    """Clamped patch rows and columns [B, h*w, 2r+2] int32 of one level."""
    from tpuflow_torch.core.corr import _base_coords, _radius_patch_indices

    idx = _radius_patch_indices(*_base_coords(flow), lvl, lh, lw, r)
    return idx.rr, idx.cc


def flow_field(g, dev, b: int, h: int, w: int, kind: str, amp: float = 40.0) -> torch.Tensor:
    """Flows [b, h, w, 2] in cells of the query grid, f32:
    - 'independent': each query's own uniform draw in +-amp;
    - 'smooth': a +-amp field drawn at 1/16 of the grid (ceil(h/16) + 1 by
      ceil(w/16) + 1 points) and upsampled bilinearly;
    - 'small': a smooth field with |flow| under 1 cell, like the model's;
    - 'mixed': smooth, with a band of rows [3h/8, 5h/8) of independent
      flows."""
    def smooth(a):
        coarse = (torch.rand((b, 2, -(-h // 16) + 1, -(-w // 16) + 1), generator=g, device=dev) * 2 - 1) * a
        up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
        return up.permute(0, 2, 3, 1).contiguous()

    def independent():
        return (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * amp

    if kind == "independent":
        return independent()
    if kind == "smooth":
        return smooth(amp)
    if kind == "small":
        return smooth(0.7)                  # |flow| <= 0.7 * sqrt(2) < 1
    if kind == "mixed":
        flow = smooth(amp)
        flow[:, 3 * h // 8: 5 * h // 8] = independent()[:, 3 * h // 8: 5 * h // 8]
        return flow
    raise ValueError(kind)


def tensor_shares(geo, pooled, grid_w: int) -> list:
    """Per level, the share of query tiles that take the tensor-core path,
    by the kernel's own rule (kernels/flashcorr2.py:tensor_path_tiles)."""
    from tpuflow_torch.kernels.flashcorr2 import tensor_path_tiles

    return [tensor_path_tiles(rr, cc, grid_w, f2l.shape[1], f2l.shape[2]).float().mean().item()
            for (rr, cc), f2l in zip(geo, pooled)]


def corr_patch_draw(g, dev, b, h, w, c, levels, dtype, kind, amp=40.0):
    """f1 [b, h*w, c], `levels` pooled target levels and flows of one field
    (flow_field)."""
    from tpuflow_torch.core.corr import _pooled_features

    f1 = torch.randn((b, h * w, c), generator=g, device=dev).to(dtype)
    pooled = [p.contiguous() for p in _pooled_features(
        torch.randn((b, h, w, c), generator=g, device=dev).to(dtype), levels)]
    return f1, pooled, flow_field(g, dev, b, h, w, kind, amp)


def corr_patch_compare(wrapper, plain, f1, pooled, flow, r):
    """(max |kernel - plain|, worst kernel-vs-plain, worst kernel-vs-f32,
    per-level tensor-path shares), the middle two in units of the entry's
    scale (see check_corr_patch)."""
    from tpuflow_torch.kernels.flashcorr2 import takes_tiles

    grid_w = flow.shape[2]
    err = vs_plain = vs_exact = 0.0
    geo = []
    for lvl, f2l in enumerate(pooled):
        rr, cc = patch_geometry(flow, lvl, f2l.shape[1], f2l.shape[2], r)
        geo.append((rr, cc))
        got = wrapper(f1, f2l, rr, cc, grid_w=grid_w).float()
        ref = plain(f1, f2l, rr, cc).float()
        exact = plain(f1.float(), f2l.float(), rr, cc)
        scale = plain(f1.float().abs(), f2l.float().abs(), rr, cc) + 1e-6
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{wrapper.__name__}: non-finite output at level {lvl}")
        err = max(err, (got - ref).abs().max().item())
        vs_plain = max(vs_plain, ((got - ref).abs() / scale).max().item())
        vs_exact = max(vs_exact, ((got - exact).abs() / scale).max().item())
    shares = tensor_shares(geo, pooled, grid_w) if takes_tiles(f1.dtype, f1.shape[2]) else [0.0] * len(pooled)
    return err, vs_plain, vs_exact, shares


def check_corr_patch_ragged(g, dev, wrapper, plain) -> None:
    """The correlation-patch kernel on ragged shapes: 2 x 13 x 17 = 442
    queries (no block of 8 divides 221 per image; 4 x 8 tiles are partial in
    both directions), C below and off the 16-byte vector width, both radii,
    flows that push whole windows off the plane.  The bf16 cases with C = 32
    and 48 run the tile kernel on smooth flows, whose tiles' boxes are partly
    clamped at the plane's edges and take the tensor-core path.  Limits as in
    check_corr_patch."""
    name = wrapper.__name__
    for c, r, dtype, levels, kind in ((32, 3, torch.float32, 3, "independent"),
                                      (20, 4, torch.bfloat16, 2, "independent"),
                                      (6, 3, torch.float32, 2, "independent"),
                                      (40, 3, torch.bfloat16, 3, "independent"),
                                      (32, 4, torch.bfloat16, 3, "smooth"),
                                      (48, 3, torch.bfloat16, 2, "smooth")):
        f1, pooled, flow = corr_patch_draw(g, dev, 2, 13, 17, c, levels, dtype, kind,
                                           20.0 if kind == "independent" else 6.0)
        err, vs_plain, vs_exact, shares = corr_patch_compare(wrapper, plain, f1, pooled, flow, r)
        edges = window_edges(flow, r, [p.shape[1:3] for p in pooled], 0)
        log(f"{name} ragged 2x13x17 C={c} r={r} L={levels} {dtype} {kind}: max |kernel - plain| = {err:.3e} "
            f"= {vs_plain:.3e} scale, |kernel - f32| = {vs_exact:.3e} scale; tensor-path tiles per level "
            f"{[round(x, 3) for x in shares]}; plane edges straddled (l, r, t, b) per level {edges}")
        lim_plain, lim_exact = (1e-5, 1e-5) if dtype == torch.float32 else (1.01 * 2**-7, 1.01 * 2**-8)
        if not (vs_plain <= lim_plain and vs_exact <= lim_exact):
            raise AssertionError(f"{name} disagrees on a ragged shape: {vs_plain} {vs_exact}")
        if kind == "smooth" and not (min(shares) > 0 and any(any(e) for e in edges)):
            raise AssertionError(f"{name}: the ragged smooth draw misses the tensor path or the plane "
                                 f"edges: {shares} {edges}")


def check_corr_patch(dev, wrapper, plain, replaces: str, also=None, memflow: bool = False) -> dict:
    """The correlation-patch kernel through one of its two wrappers (K3
    `flash2_patch_level`, K5 `flash_patch_level`), with the query grid's
    width as the path passes it: ragged shapes (check_corr_patch_ragged),
    then lookups of the untiled
    1920x1080 window: 3 x 135x240 queries, C = 256, radius 4, 4 pooled
    levels, bf16, on four flow fields (flow_field): independent +-40 cells,
    where the tiles take the per-query path at the fine levels; smooth
    +-40, where most take the tensor-core path; small, like the model's;
    mixed, where one launch runs both paths.  Each level's share of
    tensor-path tiles is logged; the kernel is timed per 4-level lookup on
    the independent and the smooth field.

    Tolerances, per entry, with scale = sum_c |f1_c| |f2_c| / sqrt(C): the
    kernel sums in f32 and rounds once to bf16 (half an ulp, 2^-9 of the
    value), so it lies within 2^-8 scale of an f32 reference; the plain
    version sums in another order, and where the f32 sums straddle a rounding
    boundary the two land one bf16 ulp apart: within 2^-7 scale.  Both limits
    carry 1 % for the f32 sums' own error, since an entry whose products all
    share a sign reaches the scale itself.  In f32 the two differ by
    summation order only: 1e-5 of scale.

    `also` = ((B, h, w), levels): one more bf16 shape the wrapper's path
    gives it, held to the same limits.  `memflow`: also a MemFlow 1080p
    frame's lookup, B = 1 on 135x240 queries, on the smooth field, checked
    and timed."""
    name = wrapper.__name__
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    check_corr_patch_ragged(g, dev, wrapper, plain)

    c, r = FEATURE_DIM, 4
    side = 2 * r + 2
    fields, worst = {}, 0.0
    for (b, h, w), levels, kind in ([(*also, "independent")] if also else []) + [
            (UNTILED_QUERIES, 4, kind) for kind in ("small", "mixed", "independent", "smooth")]:
        f1, pooled, flow = corr_patch_draw(g, dev, b, h, w, c, levels, torch.bfloat16, kind)
        err, vs_plain, vs_exact, shares = corr_patch_compare(wrapper, plain, f1, pooled, flow, r)
        worst = max(worst, err)
        log(f"{name} [{b},{h * w},{c}] r={r} L={levels} bf16 {kind}: max |kernel - plain| = {err:.3e} = "
            f"{vs_plain:.3e} scale (limit 2^-7), max |kernel - f32| = {vs_exact:.3e} scale (limit 2^-8); "
            f"tensor-path tiles per level {[round(x, 4) for x in shares]}")
        if not (vs_plain <= 1.01 * 2**-7 and vs_exact <= 1.01 * 2**-8):
            raise AssertionError(f"{name} disagrees at [{b},{h * w},{c}] L={levels} {kind}: {vs_plain} {vs_exact}")
        if (b, h, w) != UNTILED_QUERIES:
            continue
        # What each field is drawn to show, by the kernel's own rule.
        if kind == "mixed" and not 0 < shares[0] < 1:
            raise AssertionError(f"{name}: the mixed field runs one path only at level 0: {shares}")
        if kind in ("smooth", "small") and shares[0] < 0.9:
            raise AssertionError(f"{name}: only {shares[0]:.3f} of the {kind} field's level-0 tiles take "
                                 f"the tensor path")
        if kind in ("independent", "smooth"):
            fields[kind] = time_corr_patch(wrapper, plain, f1, pooled, flow, r, shares)
        del f1, pooled, flow
    row = {
        "name": name, "route": "cuda", "source": "tpuflow_torch/csrc/corr_patch.cu",
        "replaces": replaces, "max_abs_err": worst, "library_ms": None,
        "flows": "smooth", **{k: fields["smooth"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "fields": fields,
    }
    if memflow:
        _, h, w = UNTILED_QUERIES
        f1, pooled, flow = corr_patch_draw(g, dev, 1, h, w, c, 4, torch.bfloat16, "smooth")
        err, vs_plain, vs_exact, shares = corr_patch_compare(wrapper, plain, f1, pooled, flow, r)
        log(f"{name} [1,{h * w},{c}] r={r} L=4 bf16 smooth (a MemFlow frame): max |kernel - plain| = {err:.3e} = "
            f"{vs_plain:.3e} scale, max |kernel - f32| = {vs_exact:.3e} scale")
        if not (vs_plain <= 1.01 * 2**-7 and vs_exact <= 1.01 * 2**-8):
            raise AssertionError(f"{name} disagrees at [1,{h * w},{c}]: {vs_plain} {vs_exact}")
        row["max_abs_err"] = max(worst, err)
        row["at_memflow_frame"] = {"shape": [1, h * w, c], "max_abs_err": err, "library_ms": None,
                                   **time_corr_patch(wrapper, plain, f1, pooled, flow, r, shares)}
    return row


def time_corr_patch(wrapper, plain, f1, pooled, flow, r, shares) -> dict:
    """One 4-level lookup (one launch per level) through the kernel and the
    plain version, with its bound.  Least bytes for this run's data: f1
    once, each target row some patch touches once, the indices, the
    output."""
    b, h, w, _ = flow.shape
    c, side = f1.shape[2], 2 * r + 2
    geo = [patch_geometry(flow, lvl, p.shape[1], p.shape[2], r) for lvl, p in enumerate(pooled)]
    n = b * h * w
    nbytes = f1.numel() * 2
    for (rr, cc), f2l in zip(geo, pooled):
        touched = torch.zeros(f2l.shape[:3], dtype=torch.bool, device=f1.device)
        bidx = torch.arange(b, device=f1.device)[:, None, None, None]
        touched[bidx, rr.long()[:, :, :, None], cc.long()[:, :, None, :]] = True
        nbytes += int(touched.sum().item()) * c * 2 + 2 * rr.numel() * 4 + n * side * side * 2
    flops = 2.0 * c * side * side * n * len(pooled)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3

    def lookup(fn, **kw):
        return [fn(f1, f2l, rr, cc, **kw) for (rr, cc), f2l in zip(geo, pooled)]

    # Four launches of ~0.1 ms each cost about as much on the host as on the
    # card, so the lookups are queued behind a sleep and timed on the card.
    ms = time_ms(lambda: lookup(wrapper, grid_w=w), reps=10, queued=True)
    per_level = [time_ms(lambda: wrapper(f1, f2l, rr, cc, grid_w=w), reps=10, queued=True)
                 for (rr, cc), f2l in zip(geo, pooled)]
    plain_ms = time_ms(lambda: lookup(plain), reps=2, warmup=1)
    log(f"{wrapper.__name__} ms {ms:.4f} per lookup ({len(pooled)} launches; per level "
        f"{[round(t, 4) for t in per_level]})  plain {plain_ms:.4f}  "
        f"no single library call  bound {bound:.4f} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    return {"ms": ms, "ms_per_level": per_level, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations",
            "tensor_path_share_per_level": shares}


def volume_patch_fns(layout: str):
    """(one-level wrapper, its plain version, all-levels wrapper, its plain
    version, the TPU kernel it replaces) of K4 (layout 'flat') or K6
    ('band')."""
    from tpuflow_torch.kernels import bandlookup as bl, denselookup as dl

    if layout == "flat":
        return (dl.dense_patch_level, dl.dense_patch_level_plain, dl.dense_patch_levels,
                dl.dense_patch_levels_plain, "tpuflow/kernels/denselookup.py:156")
    return (bl.band_patch_level, bl.band_patch_level_plain, bl.band_patch_levels,
            bl.band_patch_levels_plain, "tpuflow/kernels/bandlookup.py:184")


def check_patch_entries(name: str, one, one_plain, levels_fn, levels_plain, vols, geo, what: str) -> None:
    """Each level through the one-level wrapper and all levels through one
    launch of the all-levels wrapper, each bitwise against its plain
    version."""
    rrs, ccs = [rr for rr, _ in geo], [cc for _, cc in geo]
    got_all, ref_all = levels_fn(vols, rrs, ccs), levels_plain(vols, rrs, ccs)
    for lvl, (vol, (rr, cc)) in enumerate(zip(vols, geo)):
        got = one(vol, rr, cc)
        torch.cuda.synchronize()
        for entry, out in (("one-level", got), ("all-levels", got_all[lvl])):
            if out.dtype != vol.dtype or not torch.equal(out, ref_all[lvl]):
                bad = (out != ref_all[lvl]).reshape(-1, rr.shape[2] ** 2).any(dim=1).nonzero()
                raise AssertionError(f"{name} ({entry} entry) is not bitwise equal to its plain version at "
                                     f"level {lvl} {tuple(vol.shape)} {vol.dtype}, {what}: queries "
                                     f"{bad[:8, 0].tolist()} of {bad.shape[0]} differ")


def volume_patch_draw(g, dev, layout: str, b, h, w, ph, pw, levels, dtype, r, flow_px):
    """Random levels for b x h x w queries (planes ph x pw halved per level;
    flat, or moved to the band layout), flows of +-flow_px, and each level's
    clamped rr, cc: (vols, flow, plane dims, [(rr, cc)] per level)."""
    vols = random_volumes(g, dev, b * h * w, ph, pw, levels, dtype)
    if layout == "band":   # [B*Nq, lh, lw] -> [B, lh, Nq, lw]
        vols = [v.reshape(b, h * w, *v.shape[1:]).transpose(1, 2).contiguous() for v in vols]
    flow = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * flow_px
    dims = [(v.shape[1], v.shape[-1]) for v in vols]
    return vols, flow, dims, [patch_geometry(flow, lvl, lh, lw, r) for lvl, (lh, lw) in enumerate(dims)]


def check_volume_patch_ragged(g, dev, layout: str) -> None:
    """K4 (layout 'flat') or K6 ('band') through both entries on ragged
    shapes: radius 0, 1, 4 and 14, in f32 and bf16, 3 x 7x11 = 231 queries
    (no run of the kernel divides them but 1), or 2 x 9x11; flows of up to
    1.5x the plane put patches across each edge of each level's plane
    (asserted) and wholly off it, so each launch holds rows whose columns
    are contiguous and rows whose columns are clamped (asserted); then
    indices drawn anywhere in the plane, f32 and bf16."""
    one, one_plain, levels_fn, levels_plain, _ = volume_patch_fns(layout)
    name = one.__name__
    for (b, h, w), (ph, pw), levels, dtype, r_ in (((3, 7, 11), (7, 11), 3, torch.float32, 0),
                                                   ((3, 7, 11), (7, 11), 3, torch.bfloat16, 0),
                                                   ((3, 7, 11), (9, 13), 2, torch.bfloat16, 1),
                                                   ((3, 7, 11), (9, 13), 2, torch.float32, 1),
                                                   ((3, 7, 11), (24, 31), 2, torch.bfloat16, 4),
                                                   ((2, 9, 11), (24, 31), 3, torch.float32, 4),
                                                   ((3, 7, 11), (64, 72), 2, torch.bfloat16, 14),
                                                   ((3, 7, 11), (64, 72), 2, torch.float32, 14)):
        side = 2 * r_ + 2
        vols, flow, dims, geo = volume_patch_draw(g, dev, layout, b, h, w, ph, pw, levels, dtype, r_,
                                                  1.5 * max(ph, pw))
        edges = window_edges(flow, r_, dims, 0)
        wide = [(cc[..., -1] - cc[..., 0] == side - 1).float().mean().item() for _, cc in geo]
        if not all(all(e) for e in edges) or not any(0 < s < 1 for s in wide):
            raise AssertionError(f"{name} ragged draw misses a plane edge or a mix of contiguous and "
                                 f"clamped rows: edges {edges}, contiguous shares {wide}")
        check_patch_entries(name, one, one_plain, levels_fn, levels_plain, vols, geo, f"r={r_}")
        log(f"{name} ragged {b}x{h}x{w} r={r_} {dtype} planes {dims}: bitwise equal to its plain version "
            f"(one-level and all-levels entries); share of queries with contiguous columns per level "
            f"{[round(s, 3) for s in wide]}")
    # Indices drawn anywhere in the plane, not a window: columns that span
    # more than a patch side, which the kernel reads entry by entry.
    for dtype in (torch.float32, torch.bfloat16):
        vols, _, dims, _ = volume_patch_draw(g, dev, layout, 3, 7, 11, 24, 31, 2, dtype, 4, 1.0)
        geo = [tuple(torch.randint(0, n, (3, 77, 10), generator=g, device=dev, dtype=torch.int32)
                     for n in (lh, lw)) for lh, lw in dims]
        scattered = [((cc.max(dim=2).values - cc.min(dim=2).values) >= 10).float().mean().item() for _, cc in geo]
        if not min(scattered) > 0:
            raise AssertionError(f"{name}: the scattered draw has no query whose columns span past a side")
        check_patch_entries(name, one, one_plain, levels_fn, levels_plain, vols, geo, "scattered indices")
        log(f"{name} scattered indices 3x7x11 side 10 {dtype} planes {dims}: bitwise equal to its plain version; "
            f"share of queries whose columns span past a side per level {[round(x, 3) for x in scattered]}")


def check_volume_patch(dev, layout: str) -> dict:
    """The volume-patch kernel through K4 (layout 'flat', levels
    [B*Nq, lh, lw]) or K6 (layout 'band', levels [B, lh, Nq, lw]), each
    through its one-level wrapper and its all-levels wrapper (one launch): a
    copy of volume entries, so kernel and plain version must be bitwise
    equal.  Ragged shapes (check_volume_patch_ragged), then the tile shape:
    6 x 135x120 queries, 4 bf16 levels, r = 4, flows of +-40 px, timed."""
    one, one_plain, levels_fn, levels_plain, replaces = volume_patch_fns(layout)
    name = one.__name__
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    check_volume_patch_ragged(g, dev, layout)

    (b, h, w), levels, r_ = TILE_QUERIES, 4, 4
    vols, flow, dims, geo = volume_patch_draw(g, dev, layout, b, h, w, h, w, levels, torch.bfloat16, r_, 40.0)
    check_patch_entries(name, one, one_plain, levels_fn, levels_plain, vols, geo, "tile shape")
    side = 2 * r_ + 2
    wide = [(cc[..., -1] - cc[..., 0] == side - 1).float().mean().item() for _, cc in geo]
    log(f"{name} {b}x{h}x{w} L={levels} r={r_} bf16: bitwise equal to its plain version; share of queries "
        f"with contiguous columns per level {[round(x, 3) for x in wide]}")

    # Least bytes: each distinct entry a patch needs read once (clamped
    # indices repeat at the border), the indices, the output.
    nbytes = 0
    for vol, (rr, cc) in zip(vols, geo):
        rows = rr.max(dim=2).values - rr.min(dim=2).values + 1
        cols = cc.max(dim=2).values - cc.min(dim=2).values + 1
        nbytes += int((rows * cols).sum().item()) * 2 + 2 * rr.numel() * 4 + rr.shape[0] * rr.shape[1] * side * side * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3

    bidx = torch.arange(b, device=dev)[:, None, None, None]
    qidx = torch.arange(h * w, device=dev)[None, :, None, None]
    long_geo = [(rr.long()[:, :, :, None], cc.long()[:, :, None, :]) for rr, cc in geo]

    def indexing():
        """Yardstick, never used by the port: one advanced-indexing gather per
        level."""
        if layout == "band":
            return [v[bidx, ri, qidx, ci] for v, (ri, ci) in zip(vols, long_geo)]
        return [v.view(b, h * w, *v.shape[1:])[bidx, qidx, ri, ci] for v, (ri, ci) in zip(vols, long_geo)]

    rrs, ccs = [rr for rr, _ in geo], [cc for _, cc in geo]
    for got, vol, (rr, cc) in zip(indexing(), vols, geo):
        if not torch.equal(got, one(vol, rr, cc)):
            raise AssertionError(f"{name}: the indexing yardstick computes another function")

    def lookup():
        return levels_fn(vols, rrs, ccs)

    # Device time: the card sleeps while the host enqueues every call, so
    # the host's launch cost does not show.  Host time: CUDA events around
    # calls on an idle card, the launch cost included, as a caller sees it.
    ms = time_ms(lookup, reps=20, queued=True)
    host_ms = time_ms(lookup, reps=20)
    per_level = [time_ms(lambda: one(v, rr, cc), reps=20, queued=True) for v, (rr, cc) in zip(vols, geo)]
    plain_ms = time_ms(lambda: levels_plain(vols, rrs, ccs), reps=5)
    library_ms = time_ms(indexing, reps=5)
    log(f"{name} ms {ms:.4f} per lookup on the device (one launch; one level at a time "
        f"{[round(t, 4) for t in per_level]})  host-clocked {host_ms:.4f}  plain {plain_ms:.4f}  "
        f"indexing {library_ms:.4f}  bound {bound:.4f} ({nbytes / 1e6:.1f} MB), device time / bound "
        f"{ms / bound:.2f}")
    return {
        "name": name, "route": "cuda", "source": "tpuflow_torch/csrc/volume_patch.cu",
        "replaces": replaces, "max_abs_err": 0.0, "ms": ms, "host_ms": host_ms, "ms_per_level": per_level,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
    }


# PCBlock4's depthwise stages, each with its k = 1 entry folded in: (stage,
# B, h, w, channels, k, launches a MemFlow 1080p iteration).  MemFlow's at
# 1080p (a 135 x 240 grid, B = 1); MOF's convc1 (648 channels) and conv (400)
# at the tile shape (2 tiles x 3 interior frames of a 135 x 120 grid), which
# no MemFlow frame runs.
DEPTHWISE_STAGES = (("convf2+flow_head", 1, 135, 240, 128, 15, 2), ("convc2", 1, 135, 240, 256, 15, 1),
                    ("convc1", 1, 135, 240, 324, 15, 1), ("conv", 1, 135, 240, 384, 15, 1),
                    ("gru", 1, 135, 240, 512, 7, 1), ("mof convc1", 6, 135, 120, 648, 15, 0),
                    ("mof conv", 6, 135, 120, 400, 15, 0))
# Ragged shapes (b, h, w, C, k, row pads or None, x's offset in elements into
# its buffer): a frame under the kernel, channel tails of 4 (8-byte loads)
# and odd counts (element loads), unaligned starts, a strip's pads at the
# frame's top, bottom and inside, each k the kernel takes.
DEPTHWISE_RAGGED = ((1, 5, 9, 12, 15, None, 0), (3, 19, 37, 324, 15, None, 0), (2, 17, 33, 3, 7, None, 0),
                    (2, 17, 33, 20, 7, (0, 1), 1), (1, 30, 40, 12, 15, (7, 0), 0),
                    (1, 30, 40, 12, 15, (0, 7), 0), (1, 30, 40, 24, 15, (3, 5), 4),
                    (2, 16, 16, 64, 1, None, 0), (1, 21, 50, 24, 7, (3, 0), 0), (1, 21, 50, 24, 1, None, 3),
                    (1, 21, 50, 24, 15, (2, 5), 0), (3, 9, 70, 40, 15, (7, 7), 2))


def depthwise_draw(g, dev, b, h, w, c, k, dtype, offset: int = 0):
    """NHWC x (starting `offset` elements into its buffer), a depthwise
    weight at a conv's init scale (1 / k), a bias, and a pointwise entry's
    weight and bias, all of `dtype`."""
    buf = torch.randn(b * h * w * c + offset, generator=g, device=dev).to(dtype)
    x = buf[offset:].view(b, h, w, c)
    wt = (torch.randn((c, 1, k, k), generator=g, device=dev) / k).to(dtype)
    bias = (torch.randn(c, generator=g, device=dev) * 0.1).to(dtype)
    pw = (torch.randn((c, 1, 1, 1), generator=g, device=dev) * 0.5).to(dtype)
    pb = (torch.randn(c, generator=g, device=dev) * 0.1).to(dtype)
    return x, wt, bias, pw, pb


def depthwise_compare(x, wt, bias, pw, pb, pads=None) -> dict:
    """K7 with the pointwise entry folded in equals the k = 1 launch followed
    by the unfolded one, bit for bit (the prologue repeats the k = 1
    stage's roundings); each of those two against the plain twin on the
    card within one rounding: both sum the same products in f32 in other
    orders and round once, so they part by at most one step of x's dtype
    (bf16: 2^-7 relative) beyond the sums' own difference (some 1e-6)."""
    from tpuflow_torch.kernels.depthwise import depthwise_residual_gelu, depthwise_residual_gelu_plain

    fused = depthwise_residual_gelu(x, wt, bias, pw, pb, pads=pads)
    x1 = depthwise_residual_gelu(x, pw, pb)
    unfused = depthwise_residual_gelu(x1, wt, bias, pads=pads)
    torch.cuda.synchronize()
    shape = f"{tuple(x.shape)} k {wt.shape[-1]} pads {pads} {x.dtype}"
    if not torch.equal(fused, unfused):
        diff = (fused.float() - unfused.float()).abs().max().item()
        raise AssertionError(f"depthwise {shape}: the fold differs from its two launches by {diff}")
    rtol = 2 ** -7 if x.dtype == torch.bfloat16 else 1e-5
    errs = {}
    for what, got, ref in (("k1", x1, depthwise_residual_gelu_plain(x, pw, pb)),
                           ("stage", unfused, depthwise_residual_gelu_plain(x1, wt, bias, pads=pads))):
        if got.shape != ref.shape:
            raise AssertionError(f"depthwise {shape} {what}: shape {tuple(got.shape)}, plain {tuple(ref.shape)}")
        err = (got.float() - ref.float()).abs()
        over = err > rtol * ref.float().abs() + 1e-5
        if over.any() or not torch.isfinite(got).all():
            raise AssertionError(f"depthwise {shape} {what}: {int(over.sum())} entries off the plain twin, "
                                 f"largest {err.max().item():.3e}")
        errs[what] = err.max().item()
    return errs


def check_depthwise_ragged(g, dev) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, w, c, k, pads, offset in DEPTHWISE_RAGGED:
            depthwise_compare(*depthwise_draw(g, dev, b, h, w, c, k, dtype, offset), pads)
    log(f"depthwise ragged: {2 * len(DEPTHWISE_RAGGED)} shapes agree (bf16 and f32)")


def check_depthwise(dev) -> dict:
    """K7 on the ragged shapes, then at DEPTHWISE_STAGES in bf16 with the
    pointwise entry folded in: against its plain twin, with its time, its
    bound, the plain twin's time and library_ms, the module's former
    composition on the same NHWC tensors (cuDNN's grouped convolutions, the
    adds and GELUs): a yardstick that the port never calls.  The bound is
    the larger of the bytes (x read and y written once) and the useful
    operations at the tensor cores' bf16 rate with f32 sums (wgmma, as a
    banded Toeplitz product could run them); `fma_ms` is the operations on
    the CUDA cores' f32 FMAs, the bound of K7's present design."""
    import torch.nn.functional as F

    from tpuflow_torch.core.encoders import gelu
    from tpuflow_torch.kernels.depthwise import depthwise_residual_gelu, depthwise_residual_gelu_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    check_depthwise_ragged(g, dev)
    stages, frame = [], {"ms": 0.0, "bound_ms": 0.0, "fma_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for name, b, h, w, c, k, per_iter in DEPTHWISE_STAGES:
        x, wt, bias, pw, pb = depthwise_draw(g, dev, b, h, w, c, k, torch.bfloat16)
        errs = depthwise_compare(x, wt, bias, pw, pb)
        xc = x.permute(0, 3, 1, 2)

        def library():
            y = gelu(xc + F.conv2d(xc, pw, pb, groups=c))
            return gelu(y + F.conv2d(y, wt, bias, padding=k // 2, groups=c))

        ms = time_ms(lambda: depthwise_residual_gelu(x, wt, bias, pw, pb), reps=20, queued=True)
        plain_ms = time_ms(lambda: depthwise_residual_gelu_plain(x, wt, bias, pw, pb), reps=3)
        library_ms = time_ms(library, reps=5)
        n = b * h * w * c
        flops = 2 * n * (k * k + 1)                                # k^2 taps and the prologue's FMA
        ops_ms = flops / BF16_FLOP_PER_S * 1e3
        bytes_ms = (2 * n * 2 + 2 * c * (k * k + 3)) / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        row = {"stage": name, "shape": [b, h, w, c], "k": k, "ms": ms, "bound_ms": bound_ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "ops_bound_ms": ops_ms,
               "bytes_bound_ms": bytes_ms, "fma_ms": flops / F32_FLOP_PER_S * 1e3,
               "roofline_pct": 100 * bound_ms / ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "max_abs_err": errs}
        log(f"depthwise {name} [{b}, {h}, {w}, {c}] k {k}: {ms:.4f} ms (bound {bound_ms:.4f}, "
            f"{row['roofline_pct']:.1f} %; f32 FMAs {row['fma_ms']:.4f}), plain {plain_ms:.3f} ms, "
            f"library {library_ms:.3f} ms, errors {errs}")
        stages.append(row)
        for key in frame:
            frame[key] += 12 * per_iter * row[key]
        del x, wt, bias, pw, pb, xc
    frame["roofline_pct"] = 100 * frame["bound_ms"] / frame["ms"]
    log(f"depthwise per MemFlow 1080p frame (12 iterations): {json.dumps(frame)}")
    return {"name": "depthwise_residual_gelu", "route": "cuda", "source": "tpuflow_torch/csrc/depthwise.cu",
            "replaces": "no TPU kernel (the JAX package left PCBlock4's depthwise convs to XLA)",
            "stages": stages, "per_memflow_frame": frame}


# PCBlock4's five 1x1 convolutions (K8), per block: (K, N, residual, GELU)
# from the block's (c_in, c_out) and its output GELU (the motion encoders'
# gelu(convc1)).  MOF at the tile shape (6 rows of a 135 x 120 grid),
# MemFlow at 1080p (1 x 135 x 240); six blocks a refinement step each.
POINTWISE_BLOCKS = {
    "mof": (6 * 135 * 120, (("convc1", 648, 256, True), ("convc2", 256, 192, False), ("convf2", 128, 64, False),
                            ("conv", 400, 172, False), ("gru", 512, 128, False), ("flow_head", 128, 4, False))),
    "memflow": (135 * 240, (("convc1", 324, 256, True), ("convc2", 256, 192, False), ("convf2", 128, 64, False),
                            ("conv", 384, 126, False), ("gru", 512, 128, False), ("flow_head", 128, 2, False))),
}
POINTWISE_PER_PCBLOCK = 5
# Ragged shapes (M, K, N, residual, act, x's offset in elements, extra
# elements at the end of x's and the residual's rows, output rows padded):
# tails of every tile and k-step, K that takes 8-, 4-, 2- and 1-element
# copies and K that a 16-byte copy straddles (rows padded as the FFN's
# middle tensor is), N below the narrowest tile and past the widest,
# unaligned starts and strided rows.
POINTWISE_RAGGED = ((1, 8, 1, False, False, 0, 0, False), (127, 9, 3, True, True, 0, 0, True),
                    (129, 18, 9, True, False, 1, 0, False), (300, 20, 100, False, True, 2, 4, True),
                    (257, 130, 257, True, True, 0, 6, False), (200, 65, 513, True, True, 0, 1, True),
                    (513, 648, 972, True, True, 4, 0, True), (384, 972, 256, False, True, 0, 4, False),
                    (131, 486, 324, True, True, 0, 2, False), (64, 40, 8, True, True, 3, 0, False),
                    (1000, 256, 1, False, False, 0, 0, True), (150, 24, 40, True, True, 0, 0, False),
                    (90, 48, 70, True, False, 0, 2, True), (333, 136, 200, True, True, 0, 0, False),
                    (257, 972, 648, True, True, 0, 4, False), (77, 20, 30, False, True, 0, 4, True))


def pointwise_shapes() -> list:
    """Each distinct (cell, M, K, N, residual, act, x's row padding, output
    rows padded) of both cells' SK blocks, as PCBlock4 launches them (the
    FFN's middle tensor written with rows padded to 16 bytes and read so),
    with its convolutions and its launches a refinement step."""
    from tpuflow_torch.kernels.pointwise import _padded

    rows = {}
    for cell, (m, blocks) in POINTWISE_BLOCKS.items():
        for block, c_in, c_out, act_out in blocks:
            mid = int(1.5 * c_in)
            for conv, k, n, res, act, x_pad, pad in (
                    ("ffn1.0", c_in, mid, False, True, 0, True), ("ffn1.2", mid, c_in, True, True, _padded(mid) - mid, False),
                    ("pw", c_in, c_in, True, True, 0, False), ("ffn2.0", c_in, mid, False, True, 0, True),
                    ("ffn2.2", mid, c_out, False, act_out, _padded(mid) - mid, False)):
                key = (cell, m, k, n, res, act, x_pad, pad)
                rows.setdefault(key, {"convs": [], "per_step": 0})
                rows[key]["convs"].append(f"{block}.{conv}")
                rows[key]["per_step"] += 1
    return [(*key, v["convs"], v["per_step"]) for key, v in rows.items()]


def pointwise_draw(g, dev, m, k, n, dtype, offset: int = 0, pad: int = 0):
    """x [m, k] (starting `offset` elements into its buffer, rows k + pad
    apart), a 1x1 conv's weight [n, k, 1, 1] at its init scale, a bias and a
    residual [m, n] (rows n + pad apart), all of `dtype`."""
    buf = torch.randn(m * (k + pad) + offset, generator=g, device=dev).to(dtype)
    x = buf[offset:].view(m, k + pad)[:, :k]
    wt = (torch.randn((n, k, 1, 1), generator=g, device=dev) / math.sqrt(k)).to(dtype)
    bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(dtype)
    res = torch.randn((m, n + pad), generator=g, device=dev).to(dtype)[:, pad:]
    return x, wt, bias, res


def pointwise_compare(x, wt, bias, res, act: bool, pad: bool = False) -> float:
    """K8 against its plain twin on the card within one rounding: both sum
    the same products in f32 in other orders and round once, so they part
    by at most one step of x's dtype (bf16: 2^-7 relative) beyond the sums'
    own difference.  pad: the output's rows padded to 16 bytes, which must
    show in its strides.  Returns the largest |kernel - twin|."""
    from tpuflow_torch.kernels.pointwise import _padded, pointwise_gemm, pointwise_gemm_plain

    got = pointwise_gemm(x, wt, bias, res, act=act, pad=pad)
    torch.cuda.synchronize()
    ref = pointwise_gemm_plain(x, wt, bias, res, act)
    n = wt.shape[0]
    shape = (f"x {tuple(x.shape)} strides {x.stride()} N {n} residual {res is not None} act {act} pad {pad} "
             f"{x.dtype}")
    if got.shape != ref.shape or got.stride(0) != (_padded(n) if pad else n):
        raise AssertionError(f"pointwise {shape}: shape {tuple(got.shape)} strides {got.stride()}, "
                             f"plain {tuple(ref.shape)}")
    rtol = 2 ** -7 if x.dtype == torch.bfloat16 else 1e-5
    err = (got.float() - ref.float()).abs()
    over = err > rtol * ref.float().abs() + (1e-3 if x.dtype == torch.bfloat16 else 1e-5)
    if over.any() or not torch.isfinite(got).all():
        raise AssertionError(f"pointwise {shape}: {int(over.sum())} entries off the plain twin, "
                             f"largest {err.max().item():.3e}")
    return err.max().item()


def check_pointwise_ragged(g, dev) -> None:
    n_checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        for m, k, n, residual, act, offset, row_pad, pad in POINTWISE_RAGGED:
            x, wt, bias, res = pointwise_draw(g, dev, m, k, n, dtype, offset, row_pad)
            pointwise_compare(x, wt, bias, res if residual else None, act, pad)
            n_checked += 1
    log(f"pointwise ragged: {n_checked} shapes agree (bf16 and f32)")


def check_pointwise(dev) -> dict:
    """K8 on the ragged shapes, then at every (M, K, N, residual, act) of both
    cells' SK blocks in bf16: against its plain twin, with its time, its
    bound (the larger of the bytes, x, W, the bias and the residual read and
    y written once, and the operations at the tensor cores' bf16 rate), the
    plain twin's time and library_ms, F.linear, the add and the GELU on the
    same tensors: a yardstick that the port never calls."""
    import torch.nn.functional as F

    from tpuflow_torch.core.encoders import gelu
    from tpuflow_torch.kernels.pointwise import pointwise_gemm, pointwise_gemm_plain, tile_width

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    check_pointwise_ragged(g, dev)
    shapes, frame = [], {cell: {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "launches": 0}
                         for cell in POINTWISE_BLOCKS}
    for cell, m, k, n, residual, act, x_pad, pad, convs, per_step in pointwise_shapes():
        x, wt, bias, res = pointwise_draw(g, dev, m, k, n, torch.bfloat16, pad=x_pad)
        res = res.contiguous() if residual else None
        err = pointwise_compare(x, wt, bias, res, act, pad)
        w2 = wt.reshape(n, k)

        def library():
            y = F.linear(x, w2, bias)
            y = y if res is None else res + y
            return gelu(y) if act else y

        ms = time_ms(lambda: pointwise_gemm(x, wt, bias, res, act=act, pad=pad), reps=20, queued=True)
        plain_ms = time_ms(lambda: pointwise_gemm_plain(x, wt, bias, res, act), reps=3)
        library_ms = time_ms(library, reps=10, queued=True)
        ops_ms = 2 * m * k * n / BF16_FLOP_PER_S * 1e3
        bytes_ms = 2 * (m * k + m * n * (2 if residual else 1) + n * k + n) / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        row = {"cell": cell, "convs": convs, "M": m, "K": k, "N": n, "residual": residual, "act": act,
               "tile_n": tile_width(n), "ms": ms, "bound_ms": bound_ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "ops_bound_ms": ops_ms,
               "bytes_bound_ms": bytes_ms, "roofline_pct": 100 * bound_ms / ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "max_abs_err": err, "per_step": per_step}
        log(f"pointwise {cell} {'/'.join(convs)} M {m} K {k} N {n} res {residual} act {act}: {ms:.4f} ms "
            f"(bound {bound_ms:.4f} by {row['bound_by']}, {row['roofline_pct']:.1f} %), plain {plain_ms:.3f}, "
            f"library {library_ms:.4f}, |err| {err:.3e}")
        shapes.append(row)
        for key in ("ms", "bound_ms", "plain_ms", "library_ms"):
            frame[cell][key] += 12 * per_step * row[key]
        frame[cell]["launches"] += 12 * per_step
        del x, wt, bias, res, w2
    for cell, f in frame.items():
        f["roofline_pct"] = 100 * f["bound_ms"] / f["ms"]
        log(f"pointwise per {cell} frame (12 iterations): {json.dumps(f)}")
    return {"name": "pointwise_gemm", "route": "cuda", "source": "tpuflow_torch/csrc/pointwise_gemm.cu",
            "replaces": "no TPU kernel (the JAX package left PCBlock4's 1x1 convs to XLA)",
            "shapes": shapes, "per_frame": frame}


# K9, MemFlow's memory reader: the 1080p grid with a memory of 8 slots,
# validity patterns of batch row 0 (1 = valid), the f32 readout held to the
# plain twin (TF32 off) within MEMREAD_ERR_SHARE of its largest entry, and
# at least MEMREAD_BF16_EQUAL of its bf16 rounding bit-equal to the twin's.
MEMREAD_GRID = (135, 240)
MEMREAD_CAP = 8
MEMREAD_PATTERNS = {"noncontiguous": (1, 0, 1, 1, 0, 0, 1, 0), "all": (1,) * 8, "empty": (0,) * 8}
MEMREAD_TIMED = {8: (1,) * 8, 4: (1, 1, 1, 1, 0, 0, 0, 0)}
MEMREAD_ERR_SHARE = 1e-4
MEMREAD_BF16_EQUAL = 0.99
# Ragged shapes: (h, w, per-row validity, query dtype, rope): the 640x480
# grid (hw 4800, a ragged last query tile) with B = 2, grids whose last key
# tile is ragged too, a grid smaller than one tile, a batch row with no
# valid slot beside rows with some.
MEMREAD_RAGGED = (
    (60, 80, ((1, 0, 1, 1, 0, 0, 1, 0), (0, 1, 0, 0, 0, 0, 0, 1)), torch.bfloat16, True),
    (60, 80, ((1, 1, 1, 1, 1, 1, 1, 1), (1, 0, 0, 0, 0, 0, 0, 0)), torch.float32, False),
    (61, 83, ((0, 0, 1), (1, 1, 0), (0, 0, 0)), torch.float32, True),
    (3, 5, ((1, 0, 1, 0, 1),), torch.bfloat16, True),
    (17, 19, ((1,), (0,)), torch.float32, True),
)


def memread_draw(g, dev, h: int, w: int, validity, qdtype):
    """q [B, hw, 64] in qdtype (std 2: the softmax is not flat), keys
    [B, cap, hw, 64] and values [B, cap, hw, 128] in f32, valid [B, cap]."""
    b, cap, hw = len(validity), len(validity[0]), h * w
    q = (2 * torch.randn((b, hw, 64), generator=g, device=dev)).to(qdtype)
    keys = torch.randn((b, cap, hw, 64), generator=g, device=dev)
    values = torch.randn((b, cap, hw, 128), generator=g, device=dev)
    return q, keys, values, torch.tensor(validity, dtype=torch.float32, device=dev)


def memread_compare(what: str, q, keys, values, valid, table, ref=None) -> dict:
    """K9 against the plain twin (or `ref`, a readout of the same function):
    within MEMREAD_ERR_SHARE of the reference's largest entry and at least
    MEMREAD_BF16_EQUAL of the bf16 readout bit-equal; a batch row with no
    valid slot reads exact zeros."""
    from tpuflow_torch.kernels.memread import memory_read, memory_read_plain

    with torch.inference_mode():
        got = memory_read(q, keys, values, valid, table)
        ref = memory_read_plain(q, keys, values, valid, table) if ref is None else ref
    torch.cuda.synchronize()
    empty = valid.sum(dim=1) <= 0
    err = (got - ref).abs().max().item()
    limit = MEMREAD_ERR_SHARE * ref.abs().max().item()
    equal = (got.bfloat16() == ref.bfloat16()).float().mean().item()
    zeros = bool((got[empty] == 0).all()) if bool(empty.any()) else True
    ok = bool(torch.isfinite(got).all()) and zeros and (bool(empty.all()) or (err <= limit and equal >= MEMREAD_BF16_EQUAL))
    if not ok:
        raise AssertionError(f"memory_read {what}: max |K9 - plain| {err:.3e} (limit {limit:.3e}), bf16 "
                             f"bit-equal {equal:.6f} (at least {MEMREAD_BF16_EQUAL}), empty rows zero {zeros}")
    return {"max_abs_err": err, "limit": limit, "bf16_equal_share": equal}


def check_memory_read_ragged(g, dev) -> None:
    from tpuflow_torch.kernels.memread import rope_table

    for h, w, validity, qdtype, rope in MEMREAD_RAGGED:
        q, keys, values, valid = memread_draw(g, dev, h, w, validity, qdtype)
        table = rope_table(h, w, 64, dev) if rope else None
        memread_compare(f"ragged {h}x{w} B {len(validity)}", q, keys, values, valid, table)
    log(f"memory_read ragged: {len(MEMREAD_RAGGED)} shapes agree")


def check_memory_read(dev) -> dict:
    """K9 on the ragged shapes, then at the 1080p grid with 8 slots and a
    bf16 query: the validity patterns of MEMREAD_PATTERNS and a planted
    case (3 valid slots, each invalid one holding a valid slot's keys with
    its values negated, so that a slot let through moves the readout by its
    own size: held to the twin run on the valid slots alone, unmasked).
    Then its time at 8 and 4 valid slots beside its bound (the operations
    over the valid slots at the f32 FMA rate), the plain twin's time and
    library_ms, one F.scaled_dot_product_attention call in f32 with the
    slot mask (the memory-efficient backend; a yardstick that the port never
    calls)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tpuflow_torch.kernels.memread import memory_read, memory_read_plain, rope_rotate, rope_table

    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    check_memory_read_ragged(g, dev)
    h, w = MEMREAD_GRID
    hw, cap = h * w, MEMREAD_CAP
    table = rope_table(h, w, 64, dev)
    q, keys, values, _ = memread_draw(g, dev, h, w, ((1,) * cap,), torch.bfloat16)
    cases = {}
    for name, pattern in MEMREAD_PATTERNS.items():
        valid = torch.tensor([pattern], dtype=torch.float32, device=dev)
        cases[name] = memread_compare(f"1080p {name}", q, keys, values, valid, table)
    # Planted: slots 0-2 valid; slot s >= 3 holds slot s % 3's keys and
    # minus its values.
    src = torch.arange(cap, device=dev) % 3
    valid = (torch.arange(cap, device=dev) < 3).float()[None]
    planted_v = torch.where(valid[0, :, None, None] > 0, 1.0, -1.0) * values[:, src]
    planted_k = keys[:, src].contiguous()
    with torch.inference_mode():
        alone = memory_read_plain(q, keys[:, :3].contiguous(), values[:, :3].contiguous(), valid[:, :3], table)
        leaky = memory_read_plain(q, planted_k, planted_v, torch.ones_like(valid), table)
    cases["planted"] = memread_compare("1080p planted", q, planted_k, planted_v, valid, table, ref=alone)
    cases["planted"]["every_slot_diff"] = (leaky - alone).abs().max().item()
    del planted_k, planted_v, alone, leaky
    log(f"memory_read at {h}x{w}, {cap} slots: {json.dumps(cases)}")

    timed = {}
    for n_valid, pattern in MEMREAD_TIMED.items():
        valid = torch.tensor([pattern], dtype=torch.float32, device=dev)
        with torch.inference_mode():
            ms = time_ms(lambda: memory_read(q, keys, values, valid, table), reps=5, warmup=1)
            plain_ms = time_ms(lambda: memory_read_plain(q, keys, values, valid, table), reps=3, warmup=1)
            qr = rope_rotate(q.float(), table)[:, None]
            kr = rope_rotate(keys, table).reshape(1, 1, cap * hw, 64)
            vr = values.reshape(1, 1, cap * hw, 128)
            mask = (valid > 0).repeat_interleave(hw, dim=1)[:, None, None, :]
            try:
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)[:, 0]
                    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask),
                                         reps=3, warmup=1)
                library_err = (lib - memory_read(q, keys, values, valid, table)).abs().max().item()
            except RuntimeError as exc:
                library_ms = library_err = None
                log(f"memory_read: F.scaled_dot_product_attention (memory-efficient, f32, masked) refused: {exc}")
            del qr, kr, vr, mask
        flops = 2.0 * hw * (n_valid * hw) * (64 + 128)
        bound_ms = flops / F32_FLOP_PER_S * 1e3
        timed[n_valid] = {"ms": ms, "bound_ms": bound_ms, "bound_by": "operations (f32 FMAs)",
                          "roofline_pct": 100 * bound_ms / ms, "plain_ms": plain_ms, "library_ms": library_ms,
                          "library_max_abs_diff": library_err, "tflop": flops / 1e12}
        log(f"memory_read {n_valid} of {cap} slots valid at {h}x{w}: {ms:.3f} ms (bound {bound_ms:.3f}, "
            f"{timed[n_valid]['roofline_pct']:.1f} %), plain {plain_ms:.3f} ms, library {library_ms} ms")
    del q, keys, values, table
    torch.cuda.empty_cache()
    return {"name": "memory_read", "route": "cuda", "source": "tpuflow_torch/csrc/memory_read.cu",
            "replaces": "no TPU kernel (the JAX reader, tpuflow/core/memflownet.py:133-188, is XLA)",
            "cases_1080p": cases, "timed_1080p": timed}


def check_volume_patch_far(dev) -> dict:
    """K4 and K6 on patches that read entries beyond element offset 2^31:
    one bf16 buffer of 9000 x 500 x 500 entries (4.5 GB) read as a flat
    level [9000, 500, 500] (B = 1, Nq = 9000) and as a band level
    [1, 500, 9000, 500], beside a second level of 9000 x 100 x 100, through
    both entries, bitwise against the plain versions.  Patch origins are
    drawn over the whole plane and past its edges (r = 4)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    nq, side = 9000, 10
    out = {}
    bufs = [torch.empty(nq * lh * lw, dtype=torch.bfloat16, device=dev).normal_(generator=g)
            for lh, lw in ((500, 500), (100, 100))]
    for layout in ("flat", "band"):
        one, one_plain, levels_fn, levels_plain, _ = volume_patch_fns(layout)
        vols, geo, fars = [], [], []
        for buf, (lh, lw) in zip(bufs, ((500, 500), (100, 100))):
            vols.append(buf.view(nq, lh, lw) if layout == "flat" else buf.view(1, lh, nq, lw))
            rr, cc = (torch.randint(-side, n, (1, nq, 1), generator=g, device=dev, dtype=torch.int32)
                      + torch.arange(side, device=dev, dtype=torch.int32) for n in (lh, lw))
            rr, cc = rr.clamp(0, lh - 1).contiguous(), cc.clamp(0, lw - 1).contiguous()
            geo.append((rr, cc))
            q = torch.arange(nq, device=dev)[:, None]
            rows = q * (lh * lw) + rr[0].long() * lw if layout == "flat" else rr[0].long() * (nq * lw) + q * lw
            fars.append(int((rows + cc[0].long()[:, -1:]).max().item()))
        far = fars[0]                       # the 4.5 GB level
        if far < 2**31:
            raise AssertionError(f"{one.__name__}: the far draw reads no entry beyond 2^31 ({far})")
        check_patch_entries(one.__name__, one, one_plain, levels_fn, levels_plain, vols, geo, "beyond 2^31")
        log(f"{one.__name__} on a {layout} level of {bufs[0].numel()} bf16 entries: bitwise equal to its plain "
            f"version through both entries, farthest entry read {far} (2^31 = {2**31})")
        out[layout] = far
    del bufs, vols
    torch.cuda.empty_cache()
    return out


def synthetic_clip(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """n uint8 frames [n, h, w, 3] of one random texture moving right by
    3 px and down by 1 px per frame."""
    base = np.random.default_rng(seed).integers(0, 256, (h + n, w + 3 * n, 3), dtype=np.uint8)
    return np.stack([base[n - i : n - i + h, 3 * (n - i) : 3 * (n - i) + w] for i in range(n)])


def stage_times(engine, frames: np.ndarray):
    """One window of the main path split into its stages, host clock around
    synchronized calls of the engine's own steps: per-frame encoders on both
    tiles (FlowEngine._tile_features), window assembly (context, GMA q/k,
    both pyramids) and the 12-iteration refinement (the model calls of
    FlowEngine._window_flow).  Returns ({stage: ms}, the window's encoded
    state)."""
    from tpuflow_torch.config import TILE_SIZE

    model = engine.model
    tiles_info, groups = engine._tiling(frames.shape[1], frames.shape[2], TILE_SIZE)
    idxs = next(iter(groups.values()))
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return res

    with torch.inference_mode():
        feats, ctxs = [], []
        for f in range(engine.config.sequence_length):
            fe, cx = timed("features_per_frame",
                           lambda: engine._tile_features(frames[f], tiles_info, idxs, 0))
            feats.append(fe)
            ctxs.append(cx)
        enc = timed("encode", lambda: model.encode_from_features(torch.stack(feats, 1), torch.stack(ctxs, 1)))
        timed("refine", lambda: model.refine(enc))
    return out, enc


def profile_rows(prof) -> list:
    """[(device ms, launches, kernel name)] of a torch.profiler run, largest
    first."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def device_profile(fn):
    """(host wall ms, [(device ms, launches, kernel name)] largest first) of
    one synchronized call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, profile_rows(prof)


def profile_refine(model, enc, *args) -> dict:
    """Device time of one refinement, model.refine(enc, *args), by kernel name
    (torch.profiler), the share of the refinement's wall time the device was
    busy, and the device time and launches of the correlation-patch kernels
    (K3/K5) and of K2."""
    wall_ms, rows = device_profile(lambda: model.refine(enc, *args))
    busy = sum(r[0] for r in rows)
    log(f"profile of one refinement ({model.decoder_depth} iterations): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f} %")
    for ms, count, key in rows[:16]:
        log(f"  {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f} % {count:5d}x  {key[:100]}")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy}
    for name, marker in (("corr_patch", "corr_patch"), ("flash_attention", "flash_fwd")):
        hits = [(ms, count) for ms, count, key in rows if marker in key]
        out[f"{name}_ms"], out[f"{name}_launches"] = sum(r[0] for r in hits), sum(r[1] for r in hits)
        if hits:
            log(f"  {name} kernels: {out[f'{name}_ms']:.2f} ms over {out[f'{name}_launches']} launches")
    return out


def reset_launches(kernels) -> None:
    """Zero the tracing registry's counters (runtime/profiling.py), the
    kernels' launches among them."""
    from tpuflow_torch.runtime import profiling

    profiling.clear()


def read_launches(kernels) -> dict:
    from tpuflow_torch.runtime import profiling

    counters = profiling.snapshot()["counters"]
    return {name: counters.get(f"kernels.{name}.launches", 0) for name in kernels}


def phase_end_to_end(engine, kernels) -> dict:
    cfg = engine.config
    frames = synthetic_clip(MAIN_FRAMES, MAIN_H, MAIN_W, SEED)

    stage_times(engine, frames)                  # warms cuDNN and the kernels

    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flows = engine.compute_flows_tiled_stride1(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30

    if flows.shape != (MAIN_FRAMES, MAIN_H, MAIN_W, 2) or not np.isfinite(flows).all():
        raise AssertionError(f"bad flows: shape {flows.shape}, finite {np.isfinite(flows).all()}")
    windows = MAIN_FRAMES                        # one window (both tiles batched) per frame
    expected = expected_launches(kernels, steps=windows * cfg.decoder_depth,
                                 dense_lookup=windows * 2 * cfg.decoder_depth,   # one per direction, all levels
                                 flash_attention_fwd=windows * cfg.decoder_depth)
    log(f"end to end: {MAIN_FRAMES} frames of {MAIN_W}x{MAIN_H} in {wall:.3f} s = "
        f"{MAIN_FRAMES / wall:.4f} frames/s, peak {peak:.2f} GiB, launches {launches}, "
        f"|flow| mean {np.abs(flows).mean():.3f} max {np.abs(flows).max():.3f}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    stages, enc = stage_times(engine, frames)    # warm: the steady-state breakdown
    log("stages_ms (one window, 2 tiles):", json.dumps(stages))
    prof = profile_refine(engine.model, enc)
    return {"frames_per_s": MAIN_FRAMES / wall, "wall_s": wall, "peak_gib": peak,
            "stages_ms": stages, "refine_profile": prof, "launches": launches}


def timed_call(fn):
    """(result, seconds) of fn() on the host clock, synchronized both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_untiled(engine, kernels) -> dict:
    """One untiled 1920x1080 window (5 frames, the flow of frame 2) through
    FlowEngine.compute_flow at the full configuration: feature grid 135x240 =
    32 400 cells, above the 168x168 threshold, so 'auto' recomputes patches
    with FlashCorr2 (K3: one launch per level, direction and iteration).
    Then the same window with corr_impl='dense' (K1), which an 80 GB card can
    still hold, to show what the policy costs or saves here."""
    from tpuflow_torch.core.corr import DenseCorrPyramid, FlashCorr2

    cfg, model = engine.config, engine.model
    t = cfg.sequence_length
    frames = synthetic_clip(t, MAIN_H, MAIN_W, SEED + 5)
    out = {}
    flows, probes = {}, {}
    probe = probe_flow(engine.device, t - 2, MAIN_H // 8, MAIN_W // 8, SEED + 8)
    for impl, cls in (("auto", FlashCorr2), ("dense", DenseCorrPyramid)):
        model.corr_impl = impl
        engine.compute_flow(frames, t // 2)                    # warm-up
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        flow, wall = timed_call(lambda: engine.compute_flow(frames, t // 2))
        launches = read_launches(kernels)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if flow.shape != (MAIN_H, MAIN_W, 2) or not np.isfinite(flow).all():
            raise AssertionError(f"untiled {impl}: bad flow, shape {flow.shape}")
        lookups = 2 * cfg.decoder_depth
        expected = expected_launches(kernels, steps=cfg.decoder_depth, flash_attention_fwd=cfg.decoder_depth)
        if impl == "auto":
            expected["flash2_patch_level"] = lookups * cfg.corr_levels
        else:
            expected["dense_lookup"] = lookups
        if launches != expected:
            raise AssertionError(f"untiled {impl}: kernel launches {launches}, expected {expected}")

        # The same window in stages, through the engine's own steps.
        with torch.inference_mode():
            x = torch.from_numpy(frames[None]).to(engine.device).float() / 255.0
            enc, t_enc = timed_call(lambda: model.encode(x))
            if not (isinstance(enc.corr_fwd, cls) and isinstance(enc.corr_bwd, cls)):
                raise AssertionError(f"untiled {impl}: correlation object is {type(enc.corr_fwd).__name__}")
            _, t_ref = timed_call(lambda: model.refine(enc))
            probes[impl] = model._lookup(enc.corr_fwd, probe)
        log(f"untiled {MAIN_W}x{MAIN_H} corr_impl={impl!r} ({cls.__name__}): {wall:.3f} s per window = "
            f"{1 / wall:.4f} windows/s, peak {peak:.2f} GiB, encode {t_enc * 1e3:.1f} ms, refine "
            f"{t_ref * 1e3:.1f} ms, launches {launches}, |flow| mean {np.abs(flow).mean():.3f} "
            f"max {np.abs(flow).max():.3f}")
        out[impl] = {"wall_s": wall, "peak_gib": peak, "encode_ms": t_enc * 1e3, "refine_ms": t_ref * 1e3,
                     "launches": launches}
        if impl == "auto":
            out[impl]["refine_profile"] = profile_refine(model, enc)
        flows[impl] = flow
        del enc
        torch.cuda.empty_cache()
    model.corr_impl = cfg.corr_impl

    # bf16 volumes or patches, bf16 network, 12 iterations of feedback: the
    # two formulations round differently (f32 against storage-dtype bilinear,
    # features pooled in f32 against bf16), so they are held to the flow's
    # scale, not to rounding.
    out["auto_vs_dense"] = check_flows_agree("untiled 'auto' vs 'dense'", flows["auto"], flows["dense"])
    out["auto_vs_dense"].update(check_lookups_agree(
        "untiled 'auto' vs 'dense'", probes["auto"], probes["dense"], cfg.corr_levels))
    return out


def check_flows_agree(what: str, got: np.ndarray, ref: np.ndarray) -> dict:
    """Two bf16 runs of the same window: mean and max |difference| as shares
    of the mean |flow|, held to FLOW_MEAN_LIMIT and FLOW_MAX_LIMIT."""
    diff = np.abs(got - ref)
    scale = float(np.abs(ref).mean())
    res = {"mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max()), "mean_abs_flow": scale}
    log(f"{what}: |diff| mean {res['mean_abs_diff']:.4e} max {res['max_abs_diff']:.4e} px at mean |flow| "
        f"{scale:.4f} px = {diff.mean() / scale:.4e} and {diff.max() / scale:.4e} of it "
        f"(limits {FLOW_MEAN_LIMIT:g}, {FLOW_MAX_LIMIT:g})")
    if not (diff.mean() <= FLOW_MEAN_LIMIT * scale and diff.max() <= FLOW_MAX_LIMIT * scale):
        raise AssertionError(f"{what}: flows differ by {diff.mean()} px on average, {diff.max()} px at most, "
                             f"at a mean |flow| of {scale} px")
    return res


def probe_flow(dev, b: int, h: int, w: int, seed: int) -> torch.Tensor:
    """Flows of +-40 px [b, h, w, 2] f32 at which two correlation objects'
    lookups are compared."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand((b, h, w, 2), generator=g, device=dev) * 80.0 - 40.0).contiguous()


def check_lookups_agree(what: str, got: torch.Tensor, ref: torch.Tensor, levels: int) -> dict:
    """Correlation features [B, h, w, levels * (2r+1)^2] of two formulations
    at the same flows, level by level.  With random weights the network's
    flow hardly depends on these features (a copy of the port with the
    window's x and y axes swapped, and one with a level sampled at the wrong
    scale, both stayed inside the flow limits above), so the formulations
    are held to each other here and not only through the flow.
    Both sides read bf16 entries that differ by roundings (features pooled in
    f32 or bf16, bilinear in f32 or bf16: a few 2^-9 of the taps), so a
    level's worst entry is held to LOOKUP_MAX_LIMIT of the level's largest
    |feature| and its mean |difference| to LOOKUP_MEAN_LIMIT of its mean
    |feature|; a misplaced tap differs by the feature's own size."""
    g = got.reshape(-1, levels, got.shape[-1] // levels).float()
    r = ref.reshape(-1, levels, ref.shape[-1] // levels).float()
    worst_max = worst_mean = 0.0
    for lvl in range(levels):
        d = (g[:, lvl] - r[:, lvl]).abs()
        worst_max = max(worst_max, (d.max() / r[:, lvl].abs().max()).item())
        worst_mean = max(worst_mean, (d.mean() / r[:, lvl].abs().mean()).item())
    log(f"{what}, lookup features: worst level's max |diff| = {worst_max:.4e} of max |feature| "
        f"(limit {LOOKUP_MAX_LIMIT:g}), mean |diff| = {worst_mean:.4e} of mean |feature| "
        f"(limit {LOOKUP_MEAN_LIMIT:g})")
    if not (worst_max <= LOOKUP_MAX_LIMIT and worst_mean <= LOOKUP_MEAN_LIMIT):
        raise AssertionError(f"{what}: lookup features differ, max {worst_max}, mean {worst_mean}")
    return {"lookup_max_rel": worst_max, "lookup_mean_rel": worst_mean}


def phase_strided(engine, kernels) -> dict:
    """The multi-window entry points at full size: compute_flows_strided on
    2 (T - 2) + 1 untiled 1920x1080 frames with window_batch=2 (three windows:
    a batch of two, then one), and compute_flow_batch with two windows.  The
    frame that is the middle interior of the second strided window must get
    compute_flow's flow from either."""
    cfg = engine.config
    t = cfg.sequence_length
    n = 2 * (t - 2) + 1
    mid = (t - 3) + t // 2                      # window 1 starts at T-3
    frames = synthetic_clip(n, MAIN_H, MAIN_W, SEED + 7)
    batches = math.ceil(len(range(-1, n - 1, t - 2)) / 2)

    engine.compute_flow_batch(frames, [mid, 1])                  # warms the two-window shapes
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    flows, wall = timed_call(lambda: engine.compute_flows_strided(frames, window_batch=2))
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if flows.shape != (n, MAIN_H, MAIN_W, 2) or not np.isfinite(flows).all():
        raise AssertionError(f"strided: bad flows, shape {flows.shape}")
    expected = expected_launches(kernels, steps=batches * cfg.decoder_depth,
                                 flash_attention_fwd=batches * cfg.decoder_depth,
                                 flash2_patch_level=batches * 2 * cfg.decoder_depth * cfg.corr_levels)
    if launches != expected:
        raise AssertionError(f"strided: kernel launches {launches}, expected {expected}")
    log(f"strided: {n} untiled frames of {MAIN_W}x{MAIN_H}, window_batch=2, in {wall:.3f} s = {n / wall:.4f} "
        f"frames/s, peak {peak:.2f} GiB, launches {launches}")

    torch.cuda.reset_peak_memory_stats()
    pair, pair_wall = timed_call(lambda: engine.compute_flow_batch(frames, [mid, 1]))
    pair_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"compute_flow_batch, two windows: {pair_wall:.3f} s, peak {pair_peak:.2f} GiB")
    single = engine.compute_flow(frames, mid)
    out = {"frames": n, "wall_s": wall, "peak_gib": peak, "launches": launches,
           "batch_of_two_wall_s": pair_wall, "batch_of_two_peak_gib": pair_peak}
    # Another batch size may take another convolution algorithm, so these
    # are held as two bf16 runs are, not bit for bit.
    out["strided_vs_compute_flow"] = check_flows_agree(
        f"strided frame {mid} vs compute_flow", flows[mid], single)
    out["batch_vs_compute_flow"] = check_flows_agree(
        f"compute_flow_batch window of frame {mid} vs compute_flow", pair[0], single)
    return out


def profile_patch_lookup(what: str, whole, corr, flow, radius: int) -> dict:
    """One patch lookup of a 'patch' (DenseCorrPyramid, K4) or 'band'
    (BandCorrPyramid, K6) object at `flow` (`whole()`), timed on the device
    (queued) and on the host clock, and its device time by part as
    core/corr.py:_patch_lookup runs it: the geometry of every level
    (_radius_patch_indices) and the epilogue of every level
    (_patch_to_features), each profiled alone after a warm pass, and the
    patch kernel and the concat, read by name from a profile of the whole
    lookup."""
    from tpuflow_torch.core.corr import BandCorrPyramid, _base_coords, _patch_to_features, _radius_patch_indices
    from tpuflow_torch.kernels.bandlookup import band_patch_levels
    from tpuflow_torch.kernels.denselookup import dense_patch_levels

    levels = corr.pyramid
    band = isinstance(corr, BandCorrPyramid)
    dims = [(v.shape[1], v.shape[3] if band else v.shape[2]) for v in levels]
    b, h, w, _ = flow.shape
    st = {}

    def geometry():
        bx, by = _base_coords(flow)
        st["idx"] = [_radius_patch_indices(bx, by, lvl, lh, lw, radius) for lvl, (lh, lw) in enumerate(dims)]

    def epilogue():
        st["feats"] = [_patch_to_features(p, i, lh, lw, (b, h, w, radius))
                       for p, i, (lh, lw) in zip(st["patches"], st["idx"], dims)]

    with torch.inference_mode():
        geometry()
        fn = band_patch_levels if band else dense_patch_levels
        st["patches"] = fn(levels, [i.rr for i in st["idx"]], [i.cc for i in st["idx"]])
        epilogue()
        if not torch.equal(torch.cat(st["feats"], dim=-1), whole()):
            raise AssertionError(f"{what}: the lookup split into parts computes another function")
        ms = time_ms(whole, reps=10, queued=True)
        host_ms = time_ms(whole, reps=10)
    res = {"device_ms": ms, "host_ms": host_ms}
    for key, part in (("geometry", geometry), ("epilogue", epilogue), ("whole", whole)):
        wall_ms, rows = device_profile(part)
        res[key] = {"device_ms": sum(r[0] for r in rows), "launches": sum(r[1] for r in rows),
                    "kernels": [[round(t, 4), n, k[:80]] for t, n, k in rows[:4]]}
        if key == "whole":
            for name, pattern in (("kernel", "volume_patch"), ("cat", "CatArrayBatched")):
                hit = [(t, n) for t, n, k in rows if pattern in k]
                res[name] = {"device_ms": sum(t for t, _ in hit), "launches": sum(n for _, n in hit)}
    log(f"  {what} lookup: {ms:.4f} ms on the device, {host_ms:.4f} ms host-clocked; device time by part under "
        f"the profiler: " + ", ".join(f"{k} {res[k]['device_ms']:.4f} ms ({res[k]['launches']} kernels)"
                                      for k in ("geometry", "kernel", "epilogue", "cat", "whole")))
    return res


def phase_formulations(engine, kernels) -> dict:
    """corr_impl 'flash', 'band' and dense_lookup='patch' through MOFNet at
    the tile shape (two 960x1080 tiles of a 5-frame window: 6 batch rows of
    135x120), FORMULATION_DEPTH iterations, each against corr_impl='dense'
    at the same depth from the same encoder features."""
    cfg, model = engine.config, engine.model
    from tpuflow_torch.config import TILE_SIZE

    frames = synthetic_clip(cfg.sequence_length, MAIN_H, MAIN_W, SEED + 6)
    tiles_info, groups = engine._tiling(MAIN_H, MAIN_W, TILE_SIZE)
    idxs = next(iter(groups.values()))
    lookups = 2 * FORMULATION_DEPTH
    expected = {
        "dense": {"dense_lookup": lookups},
        "flash": {"flash_patch_level": lookups, "dense_lookup": lookups},   # level 0 + sidecar
        "band": {"band_patch_level": lookups},          # one launch per lookup, all levels
        "patch": {"dense_patch_level": lookups},
    }
    out, flows, probes = {}, {}, {}
    probe = probe_flow(engine.device, *TILE_QUERIES, SEED + 9)
    model.decoder_depth = FORMULATION_DEPTH
    try:
        with torch.inference_mode():
            per_frame = [engine._tile_features(f, tiles_info, idxs, 0) for f in frames]
            feats = torch.stack([p[0] for p in per_frame], 1)
            ctxs = torch.stack([p[1] for p in per_frame], 1)
            for name in ("dense", "flash", "band", "patch"):
                model.corr_impl = "dense" if name == "patch" else name
                model.dense_lookup = "patch" if name == "patch" else "auto"

                def run():
                    return model.refine(model.encode_from_features(feats, ctxs))

                run()                                   # warm-up: allocator, cuDNN, kernels
                reset_launches(kernels)
                (up_fwd, _), wall = timed_call(run)
                launches = read_launches(kernels)
                want = expected_launches(kernels, steps=FORMULATION_DEPTH, flash_attention_fwd=FORMULATION_DEPTH,
                                         **expected[name])
                if launches != want:
                    raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
                walls = [wall] + [timed_call(run)[1] for _ in range(2)]
                flows[name] = up_fwd.float()
                if not torch.isfinite(flows[name]).all():
                    raise AssertionError(f"{name}: non-finite flows")
                out[name] = {"wall_ms": float(np.median(walls)) * 1e3, "wall_ms_runs": [t * 1e3 for t in walls],
                             "launches": {k: v for k, v in launches.items() if v}}
                # After the counters were read: one lookup at the probe flows.
                enc = model.encode_from_features(feats, ctxs)
                probes[name] = model._lookup(enc.corr_fwd, probe)
                if name in ("patch", "band"):
                    out[name]["lookup"] = profile_patch_lookup(
                        name, lambda: model._lookup(enc.corr_fwd, probe), enc.corr_fwd, probe, model.corr_radius)
                del enc
                torch.cuda.empty_cache()
    finally:
        model.decoder_depth = cfg.decoder_depth
        model.corr_impl = cfg.corr_impl
        model.dense_lookup = "auto"
    for name in ("flash", "band", "patch"):
        log(f"formulation {name!r} at [6,135,120], {FORMULATION_DEPTH} iterations: {out[name]['wall_ms']:.1f} ms, "
            f"median of {[round(t, 1) for t in out[name]['wall_ms_runs']]} (dense {out['dense']['wall_ms']:.1f} ms), "
            f"launches {out[name]['launches']}")
        # bf16 throughout; see phase_untiled.
        out[name].update(check_flows_agree(f"formulation {name!r} vs 'dense'", flows[name].cpu().numpy(),
                                           flows["dense"].cpu().numpy()))
        out[name].update(check_lookups_agree(f"formulation {name!r} vs 'dense'", probes[name], probes["dense"],
                                             cfg.corr_levels))
    return out


# ---- other configurations and engine entries ------------------------------

SMALL_CLIP = (5, 128, 256)       # frames, H, W of the every-entry-point runs: two tiles at tile_size 128
BOF_FRAMES = 6                   # 1080p frames of the BOF tiled run
CNN_FRAMES = 4                   # 1080p frames of the cnn tiled run
BATCH_FRAMES = 4                 # 1080p frames of the window-batch runs
UHD_H, UHD_W = 2160, 3840
SINGLE_TILE_HW = (480, 640)      # a clip that fits one tile


# PCBlock4s in one step of either SK update block (convc1, convc2, convf2,
# conv, gru, flow_head): K7 launches once for each, the k = 1 entries folded
# in, and K8 once for each of its five 1x1 convs.
PCBLOCKS_PER_STEP = 6


def expected_launches(kernels, steps: int, **counts) -> dict:
    """Each kernel's launches: K7 once and K8 five times per PCBlock4 of
    each of `steps` update-block steps (one step serves a batch of windows,
    tiles or a strip), `counts` for the others named, none for the rest."""
    want = dict.fromkeys(kernels, 0)
    want["depthwise_residual_gelu"] = PCBLOCKS_PER_STEP * steps
    want["pointwise_gemm"] = POINTWISE_PER_PCBLOCK * PCBLOCKS_PER_STEP * steps
    want.update(counts)
    return want


def tiled_run(engine, kernels, frames, **kw):
    """(flows, wall s, peak GiB, launches) of one compute_flows_tiled_stride1
    call, the counters zeroed just before it and read just after."""
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    flows, wall = timed_call(lambda: engine.compute_flows_tiled_stride1(frames, **kw))
    launches = read_launches(kernels)
    if flows.shape != frames.shape[:3] + (2,) or not np.isfinite(flows).all():
        raise AssertionError(f"bad flows: shape {flows.shape}")
    return flows, wall, torch.cuda.max_memory_allocated() / 2**30, launches


def phase_entry_points(engine, what: str) -> list:
    """Every VideoFlow entry point of `engine` on a small clip (SMALL_CLIP,
    tile_size 128): finite flows of the right shape."""
    n, h, w = SMALL_CLIP
    frames = synthetic_clip(n, h, w, SEED + 11)
    outs = {
        "compute_flow": engine.compute_flow(frames, n // 2)[None],
        "compute_flow_batch": engine.compute_flow_batch(frames, [0, n - 1]),
        "compute_flows_strided": engine.compute_flows_strided(frames),
        "compute_flow_tiled": engine.compute_flow_tiled(frames, n // 2, tile_size=128)[None],
        "compute_flows_tiled_stride1": engine.compute_flows_tiled_stride1(frames, tile_size=128),
    }
    for name, out in outs.items():
        if out.shape[1:] != (h, w, 2) or not np.isfinite(out).all():
            raise AssertionError(f"{what} {name}: bad flows, shape {out.shape}")
    log(f"{what}: {', '.join(outs)} on {n} frames of {w}x{h}: finite flows of the right shape")
    return sorted(outs)


def phase_bof(kernels) -> dict:
    """VideoFlow BOF, ModelConfig(architecture='bof', sequence_length=3), at
    full width (Twins, 4 levels, radius 4, 12 iterations, bf16, seeded
    random weights): tiled stride-1 on BOF_FRAMES 1920x1080 frames (one
    interior frame per window), one untiled 1920x1080 window through the
    model (FlashCorr2, K3), whose forward and backward flows must be
    finite, and every entry point on a small clip."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.core.mofnet import BOFNet
    from tpuflow_torch.runtime.engine import FlowEngine

    engine = FlowEngine(ModelConfig(architecture="bof", sequence_length=3), seed=SEED + 12)
    engine.load_model(allow_random_init=True)
    if type(engine.model) is not BOFNet:
        raise AssertionError(f"architecture 'bof' built {type(engine.model).__name__}")
    cfg = engine.config
    frames = synthetic_clip(BOF_FRAMES, MAIN_H, MAIN_W, SEED + 12)
    engine.compute_flows_tiled_stride1(frames[:2])                 # warm-up
    _, wall, peak, launches = tiled_run(engine, kernels, frames)
    want = expected_launches(kernels, steps=BOF_FRAMES * cfg.decoder_depth,
                             dense_lookup=BOF_FRAMES * 2 * cfg.decoder_depth,
                             flash_attention_fwd=BOF_FRAMES * cfg.decoder_depth)
    if launches != want:
        raise AssertionError(f"bof tiled: kernel launches {launches}, expected {want}")
    log(f"bof tiled stride-1: {BOF_FRAMES} frames of {MAIN_W}x{MAIN_H} in {wall:.3f} s = "
        f"{BOF_FRAMES / wall:.4f} frames/s, peak {peak:.2f} GiB, launches {launches}")
    out = {"frames": BOF_FRAMES, "frames_per_s": BOF_FRAMES / wall, "wall_s": wall, "peak_gib": peak,
           "launches": launches}

    x = torch.from_numpy(frames[:3][None]).to(engine.device).float() / 255.0
    with torch.inference_mode():
        engine.model(x)                                            # warm-up
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        (fwd, bwd), wall = timed_call(lambda: engine.model(x))
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, f in (("forward", fwd), ("backward", bwd)):
        if tuple(f.shape) != (1, 1, MAIN_H, MAIN_W, 2) or not torch.isfinite(f).all():
            raise AssertionError(f"bof untiled: bad {name} flow, shape {tuple(f.shape)}")
    want = expected_launches(kernels, steps=cfg.decoder_depth,
                             flash2_patch_level=2 * cfg.decoder_depth * cfg.corr_levels,
                             flash_attention_fwd=cfg.decoder_depth)
    if launches != want:
        raise AssertionError(f"bof untiled: kernel launches {launches}, expected {want}")
    log(f"bof untiled {MAIN_W}x{MAIN_H} window: {wall:.3f} s, peak {peak:.2f} GiB, launches {launches}, "
        f"|forward| mean {fwd.abs().mean().item():.3f}, |backward| mean {bwd.abs().mean().item():.3f}")
    out["untiled"] = {"wall_s": wall, "peak_gib": peak, "launches": launches}
    del fwd, bwd, x
    out["entry_points"] = phase_entry_points(engine, "bof")
    del engine
    torch.cuda.empty_cache()
    return out


def phase_cnn(kernels, twins_feature_ms: float) -> dict:
    """VideoFlow MOF with the cnn BasicEncoder, ModelConfig(encoder='cnn'),
    at full width: tiled stride-1 on CNN_FRAMES 1920x1080 frames, the
    encoders' time per frame (both tiles, fnet and cnet) against Twins's in
    the same call, and every entry point on a small clip."""
    from tpuflow_torch.config import TILE_SIZE, ModelConfig
    from tpuflow_torch.core.encoders import BasicEncoder
    from tpuflow_torch.runtime.engine import FlowEngine

    engine = FlowEngine(ModelConfig(encoder="cnn"), seed=SEED + 13)
    engine.load_model(allow_random_init=True)
    if not isinstance(engine.model.fnet, BasicEncoder):
        raise AssertionError(f"encoder 'cnn' built {type(engine.model.fnet).__name__}")
    cfg = engine.config
    frames = synthetic_clip(CNN_FRAMES, MAIN_H, MAIN_W, SEED + 13)
    tiles_info, groups = engine._tiling(MAIN_H, MAIN_W, TILE_SIZE)
    idxs = next(iter(groups.values()))
    with torch.inference_mode():
        engine._tile_features(frames[0], tiles_info, idxs, 0)      # warm-up
        feature_ms = float(np.median([timed_call(lambda: engine._tile_features(f, tiles_info, idxs, 0))[1]
                                      for f in frames])) * 1e3
    _, rows = device_profile(lambda: engine._tile_features(frames[0], tiles_info, idxs, 0))
    busy = sum(r[0] for r in rows)
    log(f"cnn encoders of one frame under torch.profiler: device busy {busy:.2f} ms")
    for ms, count, key in rows[:8]:
        log(f"  {ms:8.2f} ms {100 * ms / max(busy, 1e-9):5.1f} % {count:4d}x  {key[:100]}")
    engine.compute_flows_tiled_stride1(frames[:1])                 # warm-up
    _, wall, peak, launches = tiled_run(engine, kernels, frames)
    want = expected_launches(kernels, steps=CNN_FRAMES * cfg.decoder_depth,
                             dense_lookup=CNN_FRAMES * 2 * cfg.decoder_depth,
                             flash_attention_fwd=CNN_FRAMES * cfg.decoder_depth)
    if launches != want:
        raise AssertionError(f"cnn tiled: kernel launches {launches}, expected {want}")
    log(f"cnn tiled stride-1: {CNN_FRAMES} frames of {MAIN_W}x{MAIN_H} in {wall:.3f} s = "
        f"{CNN_FRAMES / wall:.4f} frames/s, peak {peak:.2f} GiB, launches {launches}; encoders "
        f"{feature_ms:.2f} ms per frame (Twins {twins_feature_ms:.2f} ms in this run)")
    out = {"frames": CNN_FRAMES, "frames_per_s": CNN_FRAMES / wall, "wall_s": wall, "peak_gib": peak,
           "launches": launches, "features_per_frame_ms": feature_ms,
           "features_profile": [[round(ms, 3), count, key[:80]] for ms, count, key in rows[:8]],
           "entry_points": phase_entry_points(engine, "cnn")}
    del engine
    torch.cuda.empty_cache()
    return out


def phase_window_batch(engine, kernels) -> dict:
    """compute_flows_tiled_stride1 on BATCH_FRAMES 1920x1080 frames with
    window_batch 1 and 2 (after a warm-up of the batch of two), held to each
    other as two bf16 runs (another batch may take another cuDNN algorithm;
    whether they are bit-equal is logged), then window_batch=8, which the
    clamp cuts to what the card's free memory holds (logged), against the
    same flows.  Returns the timings and the peaks."""
    from tpuflow_torch.config import TILE_SIZE

    cfg = engine.config
    t, depth = cfg.sequence_length, cfg.decoder_depth
    frames = synthetic_clip(BATCH_FRAMES, MAIN_H, MAIN_W, SEED + 14)
    groups = engine._tiling(MAIN_H, MAIN_W, TILE_SIZE)[1]
    engine.compute_flows_tiled_stride1(frames[:2], window_batch=2)  # warm-up of a batch of two
    out, flows = {}, {}
    for wb in (1, 2, 8):
        free, total = torch.cuda.mem_get_info()
        eff = engine._clamp_window_batch(wb, t, groups)
        flows[wb], wall, peak, launches = tiled_run(engine, kernels, frames, window_batch=wb)
        batches = math.ceil(BATCH_FRAMES / eff)
        want = expected_launches(kernels, steps=batches * depth, dense_lookup=batches * 2 * depth,
                                 flash_attention_fwd=batches * depth)
        if launches != want:
            raise AssertionError(f"window_batch={wb}: kernel launches {launches}, expected {want}")
        log(f"window_batch={wb} (runs as {eff}; card free {free / 2**30:.2f} of {total / 2**30:.2f} GiB before): "
            f"{BATCH_FRAMES} frames in {wall:.3f} s = {BATCH_FRAMES / wall:.4f} frames/s, peak {peak:.2f} GiB, "
            f"launches {launches}")
        out[f"wb{wb}"] = {"runs_as": eff, "frames_per_s": BATCH_FRAMES / wall, "wall_s": wall, "peak_gib": peak,
                          "free_gib_before": free / 2**30, "launches": launches}
        if wb > 1:
            out[f"wb{wb}"]["bit_equal_to_wb1"] = bool(np.array_equal(flows[wb], flows[1]))
            out[f"wb{wb}"].update(check_flows_agree(f"window_batch={wb} vs 1", flows[wb], flows[1]))
        torch.cuda.empty_cache()
    if out["wb8"]["runs_as"] >= 8:
        raise AssertionError("window_batch=8 was not clamped on this card")
    return out


def phase_uhd(engine, kernels) -> dict:
    """One 3840x2160 frame (its centred 5-frame window) through
    compute_flow_tiled: six 1080x1280 tiles of one shape group, each with
    dense volumes of 135x160 = 21 600 cells; tile_batch=4 (chunks of 4 and
    2), tile_batch=6, tile_batch=4 again; the flows of 4 and 6 held to each
    other as two bf16 runs."""
    from tpuflow_torch.config import TILE_SIZE

    cfg = engine.config
    t, depth = cfg.sequence_length, cfg.decoder_depth
    frames = synthetic_clip(t, UHD_H, UHD_W, SEED + 15)
    groups = engine._tiling(UHD_H, UHD_W, TILE_SIZE)[1]
    if [(shape, len(idxs)) for shape, idxs in groups.items()] != [((UHD_H // 2, UHD_W // 3), 6)]:
        raise AssertionError(f"4K tiles: {groups}")
    out, flows = {"runs": []}, {}
    for tb in (4, 6, 4):
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        flow, wall = timed_call(lambda: engine.compute_flow_tiled(frames, t // 2, tile_batch=tb))
        launches = read_launches(kernels)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if flow.shape != (UHD_H, UHD_W, 2) or not np.isfinite(flow).all():
            raise AssertionError(f"4K tile_batch={tb}: bad flow, shape {flow.shape}")
        chunks = math.ceil(6 / tb)
        want = expected_launches(kernels, steps=chunks * depth, dense_lookup=chunks * 2 * depth,
                                 flash_attention_fwd=chunks * depth)
        if launches != want:
            raise AssertionError(f"4K tile_batch={tb}: kernel launches {launches}, expected {want}")
        log(f"4K {UHD_W}x{UHD_H} frame, tile_batch={tb}: {wall:.3f} s, peak {peak:.2f} GiB, launches {launches}")
        out["runs"].append({"tile_batch": tb, "wall_s": wall, "peak_gib": peak, "launches": launches})
        flows[tb] = flow
        torch.cuda.empty_cache()
    out["bit_equal"] = bool(np.array_equal(flows[4], flows[6]))
    out.update(check_flows_agree("4K tile_batch=4 vs 6", flows[4], flows[6]))
    return out


def phase_single_tile(engine) -> dict:
    """A 640x480 clip fits one tile: compute_flow_tiled and
    compute_flows_tiled_stride1 must return compute_flow's flows bit for
    bit."""
    n, (h, w) = 5, SINGLE_TILE_HW
    frames = synthetic_clip(n, h, w, SEED + 16)
    ref = [engine.compute_flow(frames, i) for i in range(n)]
    tiled = engine.compute_flow_tiled(frames, n // 2)
    stride1 = engine.compute_flows_tiled_stride1(frames)
    equal = [bool(np.array_equal(stride1[i], ref[i])) for i in range(n)]
    log(f"single tile {w}x{h}: compute_flow_tiled == compute_flow: {np.array_equal(tiled, ref[n // 2])}; "
        f"compute_flows_tiled_stride1 == compute_flow per frame: {equal}")
    if not (np.array_equal(tiled, ref[n // 2]) and all(equal)):
        raise AssertionError("a frame that fits one tile does not get compute_flow's flow")
    return {"frames": n, "shape": [h, w], "bit_equal": True}


# ---- MemFlow ----------------------------------------------------------------

MEMFLOW_FRAMES = 10              # 1080p frames of the MemFlow stream: the 8-slot ring wraps
MEMFLOW_SMALL = (6, 480, 640)    # frames, H, W of the stream below both thresholds
MEMFLOW_VALID_SLOTS = 3          # valid slots of the memory the reader is checked on


def reader_reference(reader, query: torch.Tensor, mem) -> torch.Tensor:
    """A plain readout that reads only the valid slots of batch row 0 (no
    mask): rope, one f32 softmax per query row over those slots' tokens,
    then out_proj, as MemoryReader computes it."""
    from tpuflow_torch.core.gma import conv1x1
    from tpuflow_torch.core.memflownet import rope_2d

    _, h, w, dk = query.shape
    hw, dv = h * w, mem.values.shape[-1]
    keep = mem.valid[0] > 0
    q = query[0].reshape(hw, dk).float() / math.sqrt(dk)
    k, v = mem.keys[0, keep].float(), mem.values[0, keep].float().reshape(-1, dv)
    if reader.use_rope:
        q, k = rope_2d(q, h, w), rope_2d(k, h, w)
    kt = k.reshape(-1, dk).t()
    read = torch.empty((hw, dv), device=query.device)
    for c0 in range(0, hw, 1024):
        read[c0 : c0 + 1024] = torch.softmax(q[c0 : c0 + 1024] @ kt, dim=-1) @ v
    return conv1x1(read.reshape(1, h, w, dv).to(query.dtype), reader.out_proj)


def check_memory_reader(model, qk: torch.Tensor, full) -> dict:
    """MemoryReader at the 1080p grid, on `full` (every slot written) with
    only its first MEMFLOW_VALID_SLOTS slots marked valid and each other slot
    holding a valid slot's keys with its values negated, so that a slot the
    mask let through would move the readout by its own size: against
    reader_reference, within 2^-6 of the readout's largest entry (both round
    the f32 readout to bf16 once and apply out_proj in bf16); how far a
    reader that let every slot through would be is logged beside it.  An empty memory must read
    exactly zero: out_proj of zeros, bit for bit.  Then the reader's time on
    the full memory (CUDA events, median of 5) and its operations."""
    from tpuflow_torch.core.gma import conv1x1

    reader = model.memory_reader
    cap = full.valid.shape[1]
    valid = torch.zeros_like(full.valid)
    valid[:, :MEMFLOW_VALID_SLOTS] = 1.0
    src = torch.arange(cap, device=valid.device) % MEMFLOW_VALID_SLOTS
    sign = torch.where(valid[0] > 0, 1.0, -1.0)[None, :, None, None]
    partial = full._replace(keys=full.keys[:, src], values=sign * full.values[:, src], valid=valid)
    with torch.inference_mode():
        got, ref = reader(qk, partial).float(), reader_reference(reader, qk, partial).float()
        leaky = reader_reference(reader, qk, partial._replace(valid=torch.ones_like(valid))).float()
        empty = reader(qk, model.empty_memory(1, 8 * qk.shape[1], 8 * qk.shape[2]))
        zero = conv1x1(torch.zeros(qk.shape[:3] + (full.values.shape[-1],), dtype=qk.dtype, device=qk.device),
                       reader.out_proj)
    err = (got - ref).abs().max().item()
    limit = 2**-6 * ref.abs().max().item()
    unmasked = (leaky - ref).abs().max().item()
    log(f"memory reader, {MEMFLOW_VALID_SLOTS} of {cap} slots valid at {tuple(qk.shape)}: max |reader - "
        f"reference| = {err:.3e} (limit {limit:.3e}); every slot read instead: {unmasked:.3e}; empty memory "
        f"reads out_proj(0) bit for bit: {torch.equal(empty, zero)}")
    if not (err <= limit and torch.equal(empty, zero)):
        raise AssertionError(f"memory reader disagrees with its reference: {err} (limit {limit}), "
                             f"empty reads zero: {torch.equal(empty, zero)}")
    hw = qk.shape[1] * qk.shape[2]
    flops = 2.0 * hw * cap * hw * (qk.shape[-1] + full.values.shape[-1])
    with torch.inference_mode():
        ms = time_ms(lambda: reader(qk, full), reps=5, warmup=1)
    log(f"memory reader on {cap} valid slots: {ms:.2f} ms, {flops / 1e12:.2f} TFLOP in f32 "
        f"({flops / F32_FLOP_PER_S * 1e3:.2f} ms at the f32 peak)")
    return {"max_abs_err": err, "limit": limit, "every_slot_diff": unmasked, "ms": ms, "tflop": flops / 1e12,
            "f32_bound_ms": flops / F32_FLOP_PER_S * 1e3}


def memflow_stream(engine, kernels, frames):
    """(flows, wall s, peak GiB, launches) of one stream_flows call, the
    counters zeroed just before it and read just after."""
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    flows, wall = timed_call(lambda: engine.stream_flows(frames))
    launches = read_launches(kernels)
    if flows.shape != frames.shape[:3] + (2,) or not np.isfinite(flows).all():
        raise AssertionError(f"memflow: bad flows, shape {flows.shape}")
    mem = engine.memory
    n = len(frames)
    filled = (torch.arange(mem.valid.shape[1], device=mem.valid.device) < n).float()[None]
    if not (torch.equal(mem.valid, filled) and mem.ptr.tolist() == [n]):
        raise AssertionError(f"memflow: memory after {n} frames has valid {mem.valid.tolist()}, "
                             f"ptr {mem.ptr.tolist()}")
    return flows, wall, torch.cuda.max_memory_allocated() / 2**30, launches


def phase_memflow(kernels) -> dict:
    """MemFlow at the product configuration, ModelConfig(model='memflow',
    use_rope=True) (Twins, 4 levels, radius 4, 12 iterations, a memory of 8
    slots, key 64 and value 128 channels, bf16, seeded random weights):
    - stream_flows on MEMFLOW_FRAMES 1920x1080 frames after a warm-up call:
      the 135x240 grid is above both thresholds, so each frame launches K3
      48 times (12 lookups x 4 levels), K2 12 times and K7 72 times (6
      PCBlock4s a step), K1 never; finite
      flows; after a clip of n frames the first min(n, 8) slots are valid
      and ptr = n;
    - one frame on the full memory in stages (encoders, memory reader,
      refinement; host clock around synchronized calls), and one refinement
      under the profiler (K3's and K2's device time);
    - the memory reader against a plain readout (check_memory_reader);
    - compute_flow(frames, 0) equals stream_flows's frame 0 bit for bit (both
      the pair (0, 0) on an empty memory); compute_flow_batch,
      compute_flow_tiled and compute_flows_tiled_stride1 give compute_flow's
      flows;
    - a 640x480 stream (4 800 cells: a dense pyramid, K1 once per lookup, and
      materialized GMA probabilities): K1 12 launches per frame, K2 and K3
      none."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.core.corr import FlashCorr2
    from tpuflow_torch.core.memflownet import MemFlowNet
    from tpuflow_torch.runtime.engine import FlowEngine

    engine = FlowEngine(ModelConfig(model="memflow", use_rope=True), seed=SEED + 17)
    engine.load_model(allow_random_init=True)
    model, cfg = engine.model, engine.config
    if type(model) is not MemFlowNet or model.memory_capacity != 8 or not model.memory_reader.use_rope:
        raise AssertionError(f"model 'memflow' built {type(model).__name__}")
    n = MEMFLOW_FRAMES
    frames = synthetic_clip(n, MAIN_H, MAIN_W, SEED + 17)
    engine.stream_flows(frames[:2])                                # warm-up
    flows, wall, peak, launches = memflow_stream(engine, kernels, frames)
    want = expected_launches(kernels, steps=n * cfg.decoder_depth,
                             flash2_patch_level=n * cfg.decoder_depth * cfg.corr_levels,
                             flash_attention_fwd=n * cfg.decoder_depth, memory_read=n)
    if launches != want:
        raise AssertionError(f"memflow 1080p: kernel launches {launches}, expected {want}")
    log(f"memflow stream_flows: {n} frames of {MAIN_W}x{MAIN_H} in {wall:.3f} s = {n / wall:.4f} frames/s, "
        f"peak {peak:.2f} GiB, launches {launches}, |flow| mean {np.abs(flows).mean():.3f} "
        f"max {np.abs(flows).max():.3f}")
    out = {"frames": n, "frames_per_s": n / wall, "wall_s": wall, "peak_gib": peak, "launches": launches}

    full = engine.memory
    with torch.inference_mode():
        pair = engine._upload(frames[n - 2 :])[None]
        enc, t_enc = timed_call(lambda: model.encode(pair))
        if not isinstance(enc.corr, FlashCorr2) or enc.attn is not None:
            raise AssertionError(f"memflow 1080p: {type(enc.corr).__name__}, attn materialized "
                                 f"{enc.attn is not None}")
        read, t_read = timed_call(lambda: model.memory_reader(enc.qk, full))
        _, t_ref = timed_call(lambda: model.refine(enc, read))
    stages = {"encode_ms": t_enc * 1e3, "memory_reader_ms": t_read * 1e3, "refine_ms": t_ref * 1e3}
    log("memflow stages of one frame on the full memory:", json.dumps(stages))
    out["stages_ms"] = stages
    out["refine_profile"] = profile_refine(model, enc, read)
    out["memory_reader"] = check_memory_reader(model, enc.qk, full)
    del enc, read, pair, full
    torch.cuda.empty_cache()

    short = frames[:3]
    streamed = engine.stream_flows(short)
    single = [engine.compute_flow(short, i) for i in range(len(short))]
    batch = engine.compute_flow_batch(short, [0, 2])
    tiled = engine.compute_flow_tiled(short, 1)
    stride1 = engine.compute_flows_tiled_stride1(short)
    same = {"compute_flow(0) == stream_flows[0]": np.array_equal(single[0], streamed[0]),
            "compute_flow_batch": all(np.array_equal(batch[j], single[i]) for j, i in enumerate((0, 2))),
            "compute_flow_tiled": np.array_equal(tiled, single[1]),
            "compute_flows_tiled_stride1": all(np.array_equal(stride1[i], single[i]) for i in range(len(short)))}
    log(f"memflow entry points on {len(short)} frames of {MAIN_W}x{MAIN_H}, bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"memflow entry points disagree: {same}")
    out["entry_points_bit_equal"] = sorted(same)

    sn, sh, sw = MEMFLOW_SMALL
    small = synthetic_clip(sn, sh, sw, SEED + 18)
    engine.stream_flows(small[:2])                                 # warm-up
    _, s_wall, s_peak, s_launches = memflow_stream(engine, kernels, small)
    want = expected_launches(kernels, steps=sn * cfg.decoder_depth, dense_lookup=sn * cfg.decoder_depth,
                             memory_read=sn)
    if s_launches != want:
        raise AssertionError(f"memflow {sw}x{sh}: kernel launches {s_launches}, expected {want}")
    log(f"memflow stream_flows: {sn} frames of {sw}x{sh} in {s_wall:.3f} s = {sn / s_wall:.4f} frames/s, "
        f"peak {s_peak:.2f} GiB, launches {s_launches}")
    out["small"] = {"frames": sn, "shape": [sh, sw], "frames_per_s": sn / s_wall, "wall_s": s_wall,
                    "peak_gib": s_peak, "launches": s_launches}
    del engine
    torch.cuda.empty_cache()
    return out


CHECKED_ARG = "--checked-build"


def phase_checked_start():
    """Starts this script in a child process with CHECKED_ARG (main_checked):
    the bounds-checked build of every kernel, each of the nine wrappers on its
    ragged and plane-edge shapes.  A trap poisons the CUDA context, hence the
    process of its own.  Returns the child, for phase_checked_wait."""
    from pathlib import Path

    here = Path(__file__).resolve()
    return subprocess.Popen([sys.executable, str(here), CHECKED_ARG], cwd=here.parent,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_checked_wait(child) -> dict:
    """Waits for phase_checked_start's child; its non-zero exit fails the
    run (the log says whether the kernel trapped)."""
    try:
        output, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    lines = output.splitlines()
    for line in lines:
        if "registers" not in line and "spill" not in line:
            log("  [checked]", line)
    if child.returncode != 0:
        trapped = any(k in output for k in ("unspecified launch failure", "illegal instruction",
                                            "cudaErrorLaunchFailure"))
        raise AssertionError(f"checked build: the child exited with {child.returncode}"
                             f"{' after a kernel trap (bounds guard)' if trapped else ''}")
    return json.loads(next(line for line in reversed(lines) if line.startswith("{")))


def main_checked() -> int:
    """The child of phase_checked_start: every wrapper on the bounds-checked
    libraries."""
    from tpuflow_torch.kernels import _build
    from tpuflow_torch.kernels.flashcorr import flash_patch_level, flash_patch_level_plain
    from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level, flash2_patch_level_plain

    phase_environment()
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.serve_checked()
    t0 = time.perf_counter()
    _build.build(checked=True)
    build_s = time.perf_counter() - t0
    served = {name: _build.library(name)._name for name in _build.SOURCES}
    if not all("-checked-" in path for path in served.values()):
        raise AssertionError(f"the wrappers are not served the checked build: {served}")
    kernels = kernel_counters()
    reset_launches(kernels)
    check_dense_lookup_ragged(torch.Generator(device=dev).manual_seed(SEED), dev)
    check_flash_attention_ragged(qkv_draws(dev))
    for wrapper, plain in ((flash2_patch_level, flash2_patch_level_plain),
                           (flash_patch_level, flash_patch_level_plain)):
        check_corr_patch_ragged(torch.Generator(device=dev).manual_seed(SEED + 3), dev, wrapper, plain)
    for layout in ("flat", "band"):
        check_volume_patch_ragged(torch.Generator(device=dev).manual_seed(SEED + 4), dev, layout)
    check_depthwise_ragged(torch.Generator(device=dev).manual_seed(SEED + 40), dev)
    check_pointwise_ragged(torch.Generator(device=dev).manual_seed(SEED + 41), dev)
    check_memory_read_ragged(torch.Generator(device=dev).manual_seed(SEED + 42), dev)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    if min(launches.values()) < 1:
        raise AssertionError(f"a wrapper was not launched on the checked build: {launches}")
    log(f"checked build: {build_s:.1f} s to build, every guard held on the ragged shapes, launches {launches}")
    print(json.dumps({"build_s": build_s, "launches": launches}))
    return 0



def phase_parity(kernels) -> dict:
    """The same weights and clip in f32 (volumes too) on the CPU and on the
    card, full configuration: tiled (two 128x128 tiles per frame, dense
    pyramids, K1), and one untiled window with the materialization threshold
    lowered to 0 so that 'auto' takes the large-grid path (FlashCorr2, K3's
    f32 kernel); then MemFlow's stream_flows over the clip with both of its
    gates lowered, so that every frame runs FlashCorr2 (K3) and GMA without
    materialized probabilities (K2's f32 kernel).  Returns each path's error
    relative to the flow scale."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.core.corr import FlashCorr2
    from tpuflow_torch.runtime.engine import FlowEngine

    n, h, w = PARITY_SHAPE
    frames = synthetic_clip(n, h, w, SEED + 2)
    out = {"tiled": {}, "untiled": {}, "memflow": {}}
    for dev in ("cpu", "cuda"):
        engine = FlowEngine(ModelConfig(), seed=SEED + 2, device=dev, dtype=torch.float32)
        engine.model.corr_dtype = torch.float32
        engine.load_model(allow_random_init=True)
        out["tiled"][dev] = engine.compute_flows_tiled_stride1(frames, tile_size=128)
        engine.model.materialize_threshold = 0
        with torch.inference_mode():
            enc = engine.model.encode(torch.zeros((1, 3, 64, 64, 3), device=engine.device))
        if not isinstance(enc.corr_fwd, FlashCorr2):
            raise AssertionError(f"parity: expected FlashCorr2 above the threshold, got {type(enc.corr_fwd).__name__}")
        out["untiled"][dev] = engine.compute_flow(frames, n // 2)
        engine = FlowEngine(ModelConfig(model="memflow", use_rope=True), seed=SEED + 2, device=dev,
                            dtype=torch.float32)
        engine.model.corr_dtype = torch.float32
        engine.load_model(allow_random_init=True)
        engine.model.materialize_threshold = engine.model.attn_materialize_bytes = 0
        reset_launches(kernels)
        out["memflow"][dev] = engine.stream_flows(frames)
        cfg = engine.config
        want = expected_launches(kernels, steps=n * cfg.decoder_depth,
                                 flash2_patch_level=n * cfg.decoder_depth * cfg.corr_levels,
                                 flash_attention_fwd=n * cfg.decoder_depth, memory_read=n)
        if dev == "cuda" and read_launches(kernels) != want:
            raise AssertionError(f"parity memflow: kernel launches {read_launches(kernels)}, expected {want}")
    rel = {}
    for path, res in out.items():
        scale = max(1.0, float(np.abs(res["cpu"]).max()))
        err = float(np.abs(res["cuda"] - res["cpu"]).max())
        rel[path] = err / scale
        log(f"parity f32 card vs cpu, {path}, on {n}x{h}x{w}: max |diff| = {err:.3e}, flow scale {scale:.3f}, "
            f"relative {err / scale:.3e}")
        # f32 with TF32 off on both: convolution and matmul sums in another
        # order, fed back through 12 iterations.
        if not np.isfinite(res["cuda"]).all() or err / scale > 2e-3:
            raise AssertionError(f"card and CPU disagree ({path}): {err} at flow scale {scale}")
    return rel


PIPELINE_FRAMES = 6              # frames of the 1080p clip the CLI processes (cut from 8 for time)
PIPELINE_FORMATS = ("gamedev", "hsv", "torchvision", "motion-vectors-rgb8", "motion-vectors-rg8")
# Card against CPU for the render's ops: uint8 outputs within 1 on at most
# this share of entries (atan2 and exp differ by an ulp between devices), or
# for 'hsv' within one step of its uint8 hue (2 degrees moves R, G or B by
# up to 255 * 2 / 60 = 8.5); TAA histories within TAA_TOL on the 0-255 scale.
U8_SHARE_LIMIT = 1e-3
HSV_HUE_STEP = 9
TAA_TOL = 1e-3


def write_clip(path: str, n: int, h: int, w: int, seed: int) -> np.ndarray:
    """An uncompressed (I420) clip of n frames: a random texture moving by
    (3, 1) px per frame under two shapes that move on their own.  Returns
    the frames as the port's FrameExtractor decodes them."""
    import cv2

    from tpuflow_torch.pipeline.video_io import FrameExtractor

    frames = synthetic_clip(n, h, w, seed)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"I420"), 24.0, (w, h))
    for i, f in enumerate(frames):
        f = f.copy()
        cv2.circle(f, (300 + 40 * i, 400), 120, (255, 64, 0), -1)
        cv2.rectangle(f, (1200, 200 + 25 * i), (1500, 500 + 25 * i), (16, 200, 240), -1)
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()
    decoded, *_ = FrameExtractor(path).extract_frames(max_frames=n, progress=False)
    return np.stack(decoded)


class StageClock:
    """Host-clock time of a CLI run's stages, taken by wrapping the methods
    that run them (restored by close()): decode (FrameExtractor.extract_frames),
    flows (FlowPipeline.compute_all_flows, synchronized), the engine's entry
    inside it (synchronized; an entry called by another counts once), the
    cache writes on its thread pool (FlowCacheManager.save_flow_to_cache,
    summed over the threads), the --save-flow directory, render (_render_loop,
    synchronized) with its device step per frame (RenderStep.__call__: CUDA
    events around the uploads, ops and fetches, and the host clock), LODs
    (generate_lods_for_cache) and their audit (print_lod_cache_statistics).
    `check`: a callable run after each RenderStep call, outside the clock."""

    def __init__(self, check=None):
        import threading

        from tpuflow_torch.pipeline.cache import FlowCacheManager
        from tpuflow_torch.pipeline.video_io import FrameExtractor
        from tpuflow_torch.runtime.engine import FlowEngine
        from tpuflow_torch.tools.pipeline import FlowPipeline, RenderStep

        self.s = {}
        self.active = set()
        self.step_event_ms, self.step_host_ms = [], []
        self.lock = threading.Lock()
        self.restore = []
        for owner, name, key, sync in ((FrameExtractor, "extract_frames", "decode", False),
                                       (FlowPipeline, "compute_all_flows", "flows", True),
                                       (FlowEngine, "compute_flows_tiled_stride1", "engine", True),
                                       (FlowEngine, "compute_flow_batch", "engine", True),
                                       (FlowEngine, "compute_flows_strided", "engine", True),
                                       (FlowEngine, "stream_flows", "engine", True),
                                       (FlowCacheManager, "save_flow_to_cache", "cache_write_thread", False),
                                       (FlowCacheManager, "save_optical_flow_files", "save_flow_dir", False),
                                       (FlowPipeline, "_render_loop", "render", True),
                                       (FlowCacheManager, "generate_lods_for_cache", "lods", False),
                                       (FlowCacheManager, "print_lod_cache_statistics", "lod_audit", False)):
            self._wrap(owner, name, key, sync)
        orig = RenderStep.__call__

        def step(this, *args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            got = orig(this, *args)
            e1.record()
            e1.synchronize()
            self.step_host_ms.append((time.perf_counter() - t0) * 1e3)
            self.step_event_ms.append(e0.elapsed_time(e1))
            if check is not None:
                check(this, args, got)
            return got

        RenderStep.__call__ = step
        self.restore.append((RenderStep, "__call__", orig))

    def _wrap(self, owner, name, key, sync):
        orig = getattr(owner, name)

        def timed(*args, **kw):
            if key in self.active:                   # called by a clocked entry of its own key
                return orig(*args, **kw)
            if sync:
                self.active.add(key)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                    self.active.discard(key)
                with self.lock:
                    self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0

        setattr(owner, name, timed)
        self.restore.append((owner, name, orig))

    def close(self) -> None:
        for owner, name, orig in reversed(self.restore):
            setattr(owner, name, orig)


class RenderCheck:
    """The render's device work against the same ops on the CPU, frame by
    frame (a StageClock check): the encoded flows (and the external flow's)
    within 1 ('hsv': HSV_HUE_STEP) on at most U8_SHARE_LIMIT of entries;
    each TAA history on the card against ops.taa_step on the CPU from the
    same inputs, recomputed here: frame i, the flow of frame i-1 (flow TAA), no flow (simple) or
    frame i's external flow, and the card's history of frame i-1, within
    TAA_TOL.  The CPU's own chain of histories is kept beside it and its
    drift from the card's reported: where a pixel's luminance is far from
    its history's, the bilateral weights are exp(-80) or so, and an ulp of
    the history moves them by 80 ulps, so the two chains part by more than
    one step's rounding."""

    def __init__(self):
        self.prev_flow = None
        self.card = {}            # the card's history of the last frame, on the host
        self.chain = {}           # the CPU's own chain
        self.frames = 0
        self.worst = {"u8_share": 0.0, "taa_abs": 0.0, "taa_chain_drift": 0.0}

    def u8(self, what, got, ref, most):
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        share = float((diff > 0).mean())
        self.worst["u8_share"] = max(self.worst["u8_share"], share)
        self.worst["u8_max"] = max(self.worst.get("u8_max", 0), int(diff.max()))
        if diff.max() > most or share > U8_SHARE_LIMIT:
            raise AssertionError(f"render frame {self.frames}: {what} on the card differs from the CPU by up to "
                                 f"{diff.max()} on {share:.2e} of entries")

    def taa(self, key, step, frame, flow):
        from tpuflow_torch.pipeline import ops

        cur = torch.from_numpy(frame).float()
        fl = None if flow is None else torch.from_numpy(flow)

        def advance(hist):
            return cur if hist is None else ops.taa_step(cur, fl, hist, alpha=0.1, use_flow=fl is not None)

        card = step.hist[key].cpu()
        err = float((card - advance(self.card.get(key))).abs().max())
        self.chain[key] = advance(self.chain.get(key))
        self.card[key] = card
        self.worst["taa_abs"] = max(self.worst["taa_abs"], err)
        self.worst["taa_chain_drift"] = max(self.worst["taa_chain_drift"],
                                            float((card - self.chain[key]).abs().max()))
        if err > TAA_TOL:
            raise AssertionError(f"render frame {self.frames}: TAA history '{key}' on the card is {err:.3e} from "
                                 f"ops.taa_step(frame_i, flow_(i-1), hist_(i-1)) on the CPU")

    def __call__(self, step, args, got):
        from tpuflow_torch.pipeline import ops

        frame, flow = args[0], args[1]
        ext = args[2] if len(args) > 2 else None
        enc = lambda f: ops.encode_flow(torch.from_numpy(f), step.width, step.height, step.flow_format,
                                        step.clamp_range).numpy()
        most = HSV_HUE_STEP if step.flow_format == "hsv" else 1
        self.u8("the encoded flow", got["flow_viz"], enc(flow), most)
        if step.taa:
            self.taa("flow", step, frame, self.prev_flow)
            self.taa("simple", step, frame, None)
            if ext is not None:
                self.taa("ext", step, frame, ext)
                self.u8("the encoded external flow", got["ext_viz"], enc(ext), most)
        self.prev_flow = flow
        self.frames += 1


def run_cli(kernels, argv, check=None) -> dict:
    """tpuflow_torch.tools.cli.main(argv) in this process with the launch
    counters zeroed just before and read just after, its stages clocked
    (StageClock) and its standard output kept."""
    import contextlib
    import io

    from tpuflow_torch.tools import cli
    from tpuflow_torch.tools.pipeline import FlowPipeline

    clock = StageClock(check)
    text = io.StringIO()
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(text):
            rc, wall = timed_call(lambda: cli.main(argv))
    finally:
        clock.close()
    res = {"rc": rc, "wall_s": wall, "stages_s": clock.s, "launches": read_launches(kernels),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "stdout": text.getvalue()}
    if clock.step_event_ms:
        n = len(clock.step_event_ms)
        res["render_step_device_ms"] = float(np.mean(clock.step_event_ms))
        res["render_step_host_ms"] = float(np.mean(clock.step_host_ms))
        res["render_compose_write_ms"] = (clock.s["render"] * 1e3 - sum(clock.step_host_ms)) / n
    return res


def check_cache(what, cache_dir, frames, direct, lods_expected=True) -> None:
    """The cache of one computing run against a direct engine call on the
    same frames: .npz flows bit for bit; .flo bytes equal to FlowFileHandler's
    and the native cacheio's on those flows; every LOD file equal to
    LODGenerator on the cached flow, and ops.generate_lods on the card within
    1e-6 of it."""
    import os
    import tempfile

    from tpuflow_torch.pipeline import ops
    from tpuflow_torch.pipeline.cache import FlowCacheManager, FlowFileHandler, LODGenerator
    from tpuflow_torch.runtime import cacheio

    if not cacheio.available():
        raise AssertionError("runtime/cacheio: the native library did not build (g++)")
    mgr = FlowCacheManager()
    worst_lod = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(len(frames)):
            flow = mgr.load_cached_flow(cache_dir, i, "npz")
            if not np.array_equal(flow, direct[i]):
                raise AssertionError(f"{what}: cached flow {i} differs from the direct engine call by "
                                     f"{np.abs(flow - direct[i]).max()}")
            flo = open(os.path.join(cache_dir, f"flow_frame_{i:06d}.flo"), "rb").read()
            FlowFileHandler.save_flow_flo(direct[i], os.path.join(tmp, "numpy.flo"))
            cacheio.write_flo(os.path.join(tmp, "native.flo"), direct[i])
            for name in ("numpy.flo", "native.flo"):
                if open(os.path.join(tmp, name), "rb").read() != flo:
                    raise AssertionError(f"{what}: flow_frame_{i:06d}.flo differs from {name}")
            if not lods_expected:
                continue
            ref = LODGenerator.generate_lods(flow)
            dev = ops.generate_lods(torch.from_numpy(flow).cuda())
            for lvl in range(len(ref)):
                got = mgr.load_flow_lod(cache_dir, i, lvl)
                if not np.array_equal(got, ref[lvl]):
                    raise AssertionError(f"{what}: LOD {lvl} of frame {i} differs from LODGenerator")
                worst_lod = max(worst_lod, float(np.abs(dev[lvl].cpu().numpy() - got).max()))
    if worst_lod > 1e-6:
        raise AssertionError(f"{what}: ops.generate_lods on the card is {worst_lod} from the LOD files")
    log(f"pipeline {what}: {len(frames)} cached flows bit-equal to the direct engine call, .flo bytes equal to "
        f"FlowFileHandler's and the native cacheio's, LODs equal to LODGenerator, ops.generate_lods on the card "
        f"within {worst_lod:.1e}")


def check_video(what, path, n, w, h) -> None:
    import cv2

    cap = cv2.VideoCapture(path)
    shapes = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        shapes.append(f.shape)
    cap.release()
    if shapes != [(h, w, 3)] * n:
        raise AssertionError(f"{what}: the output video {path} decodes to {len(shapes)} frames of "
                             f"{set(shapes)}, expected {n} of {w}x{h}")


def cli_summary(what, res, n) -> dict:
    s = res["stages_s"]
    out = {k: v for k, v in res.items() if k != "stdout"}
    if "flows" in s:
        out["flows_frames_per_s"] = n / s["flows"]
        out["cache_write_thread_ms_per_frame"] = s.get("cache_write_thread", 0.0) * 1e3 / n
    if "lods" in s:
        out["lods_ms_per_frame"] = s["lods"] * 1e3 / n
    log(f"pipeline {what}: CLI {res['wall_s']:.3f} s for {n} frames, stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in s.items())
        + (f"; flows {out['flows_frames_per_s']:.4f} frames/s" if "flows_frames_per_s" in out else "")
        + (f"; render per frame: device {res['render_step_device_ms']:.2f} ms (events), host step "
           f"{res['render_step_host_ms']:.2f} ms, compose+write {res['render_compose_write_ms']:.2f} ms"
           if "render_step_device_ms" in res else "")
        + f"; peak {res['peak_gib']:.2f} GiB; launches {res['launches']}")
    return out


def profile_render_step(frames, cache_dir) -> dict:
    """One warm RenderStep call at 1080p with TAA (the render's device work
    for frame 2: uploads, encode, two TAA steps, fetches) under the
    profiler: its wall time, the device's busy time and its largest
    kernels."""
    from tpuflow_torch.pipeline.cache import FlowCacheManager
    from tpuflow_torch.tools.pipeline import RenderStep

    mgr = FlowCacheManager()
    flows = [mgr.load_cached_flow(cache_dir, i) for i in range(3)]
    step = RenderStep(torch.device("cuda", torch.cuda.current_device()), frames.shape[2], frames.shape[1],
                      "gamedev", 32.0, taa=True)
    step(frames[0], flows[0])
    step(frames[1], flows[1])
    wall_ms, rows = device_profile(lambda: step(frames[2], flows[2]))
    busy = sum(r[0] for r in rows)
    log(f"render step profile (1080p, gamedev, TAA): wall {wall_ms:.2f} ms under the profiler, device busy "
        f"{busy:.2f} ms = {100 * busy / wall_ms:.1f} %, {sum(r[1] for r in rows)} device calls")
    for ms, count, key in rows[:8]:
        log(f"  {ms:8.3f} ms {count:4d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "top": [[ms, count, key[:90]] for ms, count, key in rows[:8]]}


def phase_pipeline(kernels, engine_fps: Optional[dict] = None) -> dict:
    """The video pipeline and its CLI (tpuflow_torch.tools.cli.main, in this
    process) on a synthetic 1920x1080 clip of PIPELINE_FRAMES frames at the
    product configuration (Twins, 4 levels, radius 4, 12 iterations, T=5,
    bf16, seeded random weights) with --allow-random-init --no-autoplay
    --taa --save-flow both --uncompressed:
    - --tile (compute_flows_tiled_stride1: K1 24 and K2 12 launches per
      window); then the same cache re-rendered once per --flow-format
      (a cache hit: the cache-hit message, no launch), the RG8 one as
      --flow-only, whose video is then the --flow-input of a last rerun
      (the 2x3 grid, three TAA histories); the render's device work of
      every rerun checked against the CPU (RenderCheck);
    - the CLI's default route, untiled with --batch-frames 4
      (compute_flow_batch: K3 96 and K2 12 per batch of windows);
    - --model memflow (stream_flows: K3 48 and K2 12 per frame);
    each computing run's cache against a direct engine call on the same
    frames (check_cache) and its video decoded (check_video), with the
    stages' times (StageClock) and the peak device memory; and one
    `python3 -m tpuflow_torch.tools.cli --show-tiles` with jax, flax and
    tpuflow blocked, after importing every module of tpuflow_torch.
    engine_fps: the engine phases' frames/s ({'tiled', 'memflow'}), kept
    beside the CLI's."""
    import glob
    import os
    import pkgutil
    import tempfile

    try:
        import cv2  # noqa: F401
    except ImportError as exc:
        raise AssertionError(f"pipeline: cv2 does not import ({exc}); decode, compose and write need it")
    import tpuflow_torch
    from tpuflow_torch.runtime.engine import FlowEngine
    from tpuflow_torch.tools import cli
    from tpuflow_torch.tools.pipeline import FlowPipeline

    n, h, w = PIPELINE_FRAMES, MAIN_H, MAIN_W
    out = {"frames": n, "shape": [h, w]}
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.avi")
        frames = write_clip(clip, n, h, w, SEED + 21)
        base = ["--input", clip, "--frames", str(n), "--allow-random-init", "--no-autoplay", "--uncompressed"]

        def argv(route, *extra):
            os.makedirs(os.path.join(tmp, route), exist_ok=True)
            return base + ["--output", os.path.join(tmp, route), *extra]

        def video_of(route):
            (path,) = glob.glob(os.path.join(tmp, route, "*.avi"))
            return path

        def direct_engine(args):
            """A FlowEngine of its own for the run's model, with the seed the
            CLI's engine takes (0), and the run's cache directory."""
            cfg = cli.args_to_config(cli.build_parser().parse_args(args))
            engine = FlowEngine(cfg.model_config(), seed=0)
            engine.load_model(allow_random_init=True)
            return engine, FlowPipeline(cfg, engine).cache_dir_for(clip, 0, n)

        # --tile, and its cache re-rendered.
        args = argv("tile", "--tile", "--taa", "--save-flow", "both")
        res = run_cli(kernels, args)
        want = expected_launches(kernels, steps=n * 12, dense_lookup=n * 24, flash_attention_fwd=n * 12)
        if res["launches"] != want:
            raise AssertionError(f"pipeline --tile: kernel launches {res['launches']}, expected {want}")
        out["tile"] = cli_summary("--tile", res, n)
        out["tile"]["engine_frames_per_s"] = (engine_fps or {}).get("tiled")
        engine, cache_dir = direct_engine(args)
        direct, out["tile"]["direct_engine_s"] = timed_call(lambda: engine.compute_flows_tiled_stride1(frames))
        check_cache("--tile", cache_dir, frames, direct)
        check_video("--tile", video_of("tile"), n, 2 * w, 2 * h)
        out["tile"]["render_step_profile"] = profile_render_step(frames, cache_dir)

        reruns = {}
        for fmt in PIPELINE_FORMATS:
            extra = ["--flow-only"] if fmt == "motion-vectors-rg8" else ["--taa"]
            if fmt != PIPELINE_FORMATS[0]:
                extra.append("--skip-lods")              # the first rerun audits the LODs
            check = RenderCheck()
            res = run_cli(kernels, argv(f"rerun-{fmt}", "--tile", "--flow-format", fmt, *extra), check)
            if f"Found existing optical flow cache: {cache_dir}" not in res["stdout"]:
                raise AssertionError(f"pipeline rerun {fmt}: no cache-hit message")
            if any(res["launches"].values()) or check.frames != n:
                raise AssertionError(f"pipeline rerun {fmt}: launches {res['launches']} on a cache hit, "
                                     f"{check.frames} frames rendered")
            reruns[fmt] = {"wall_s": res["wall_s"], "stages_s": res["stages_s"], "render": check.worst}
        flow_video = video_of("rerun-motion-vectors-rg8")
        check_video("--flow-only rg8", flow_video, n, w, 2 * h)
        check = RenderCheck()
        res = run_cli(kernels, argv("flow-input", "--tile", "--taa", "--skip-lods", "--flow-input", flow_video,
                                    "--flow-format", "motion-vectors-rg8"), check)
        if any(res["launches"].values()) or check.frames != n or "ext" not in check.card:
            raise AssertionError(f"pipeline --flow-input: launches {res['launches']}, {check.frames} frames checked")
        check_video("--flow-input", video_of("flow-input"), n, 2 * w, 3 * h)
        reruns["flow-input"] = {"wall_s": res["wall_s"], "stages_s": res["stages_s"], "render": check.worst}
        log(f"pipeline reruns of the --tile cache (cache hits, no launch; render on the card against the CPU): "
            + json.dumps(reruns))
        out["reruns"] = reruns

        # The CLI's default route: untiled windows in batches of 4.
        args = argv("untiled", "--taa", "--save-flow", "both", "--batch-frames", "4")
        res = run_cli(kernels, args)
        batches = -(-n // 4)
        want = expected_launches(kernels, steps=batches * 12, flash2_patch_level=batches * 96,
                                 flash_attention_fwd=batches * 12)
        if res["launches"] != want:
            raise AssertionError(f"pipeline untiled: kernel launches {res['launches']}, expected {want}")
        out["untiled"] = cli_summary("untiled --batch-frames 4", res, n)
        cache_dir = FlowPipeline(cli.args_to_config(cli.build_parser().parse_args(args)), engine).cache_dir_for(
            clip, 0, n)
        direct, out["untiled"]["direct_engine_s"] = timed_call(lambda: np.concatenate(
            [engine.compute_flow_batch(frames, list(range(i, min(n, i + 4)))) for i in range(0, n, 4)]))
        check_cache("untiled", cache_dir, frames, direct)
        check_video("untiled", video_of("untiled"), n, 2 * w, 2 * h)
        del engine
        torch.cuda.empty_cache()

        # --model memflow.
        args = argv("memflow", "--model", "memflow", "--taa", "--save-flow", "both")
        res = run_cli(kernels, args)
        want = expected_launches(kernels, steps=n * 12, flash2_patch_level=n * 48, flash_attention_fwd=n * 12,
                                 memory_read=n)
        if res["launches"] != want:
            raise AssertionError(f"pipeline --model memflow: kernel launches {res['launches']}, expected {want}")
        out["memflow"] = cli_summary("--model memflow", res, n)
        out["memflow"]["engine_frames_per_s"] = (engine_fps or {}).get("memflow")
        engine, cache_dir = direct_engine(args)
        direct, out["memflow"]["direct_engine_s"] = timed_call(lambda: engine.stream_flows(frames))
        check_cache("--model memflow", cache_dir, frames, direct)
        check_video("--model memflow", video_of("memflow"), n, 2 * w, 2 * h)
        del engine
        torch.cuda.empty_cache()

        # The module entry, with jax and the JAX package blocked.
        mods = [m.name for m in pkgutil.walk_packages(tpuflow_torch.__path__, "tpuflow_torch.")]
        code = ("import sys, importlib, runpy\n"
                "for name in ('jax', 'jaxlib', 'flax', 'tpuflow'):\n"
                "    sys.modules[name] = None\n"
                f"for m in {mods!r}:\n"
                "    importlib.import_module(m)\n"
                f"sys.argv = ['cli', '--input', {clip!r}, '--show-tiles']\n"
                "runpy.run_module('tpuflow_torch.tools.cli', run_name='__main__')\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or "2 tiles of 960x1080" not in proc.stdout:
            raise AssertionError(f"pipeline: the module entry with jax blocked exited {proc.returncode}: "
                                 f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
        log(f"pipeline: {len(mods)} modules of tpuflow_torch import with jax, flax and tpuflow blocked; "
            f"python3 -m tpuflow_torch.tools.cli --show-tiles: {proc.stdout.strip().splitlines()[1]}")
    return out


CORRECTION_FRAMES = 3            # frames of the 1080p clip --interactive computes and then corrects
NCC_PAIRS = 16                   # full-size (100x100 search, 22x22 template) pairs of each NCC known answer
NCC_TOL = 1e-4
KNOWN_SHIFT = (-7, 5)            # the integer translation of the known-answer texture (content moves by it)
KNOWN_SOURCES = 65536            # interior sources of the known-translation check: the correction's cap
SHIFT_TOL = 0.05
SHIFT_SHARE = 0.99
PARITY_SOURCES = 512             # bad pixels of a 1080p pair run through both passes on the card and the CPU
# A response's peak is clear when it leads the second-highest entry by this
# much (or the response is 0 everywhere: a region wholly outside the frame,
# whose first entry wins on both devices); only clear peaks are compared.
PEAK_MARGIN = {"phase": 1e-4, "ncc": 1e-5}
PARITY_FLOW_TOL = 1e-3
PARITY_SIM_TOL = 1e-5
TRACE_PIXELS = 4096              # the cap of the traced frame (see trace_correction)


class CorrectionClock:
    """Times tools/correction.py's correct_frame and its coarse and fine
    passes by wrapping the module's functions (restored by close()): for each
    frame the pixels of each pass, each pass's device time (CUDA events) and
    host time (synchronized), the frame's host time, the rest of it (the host
    steps and quality maps) and its peak device memory."""

    NAMES = ("correct_frame", "coarse_correction_batch", "fine_correction_batch")

    def __init__(self):
        import inspect

        from tpuflow_torch.tools import correction as corr

        self.corr = corr
        self.orig = {name: getattr(corr, name) for name in self.NAMES}
        self.cap = inspect.signature(corr.correct_frame).parameters["max_pixels"].default
        self.frames = []
        self.current = {}
        for name in self.NAMES[1:]:
            setattr(corr, name, self._pass(name))
        corr.correct_frame = self._frame

    def _pass(self, name):
        fn = self.orig[name]

        def timed(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            torch.cuda.synchronize()
            self.current[name] = {"n": int(args[2].shape[0]), "ms": e0.elapsed_time(e1),
                                  "host_ms": (time.perf_counter() - t0) * 1e3}
            return out

        return timed

    def _frame(self, *args, **kw):
        self.current = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = self.orig["correct_frame"](*args, **kw)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        none = {"n": 0, "ms": 0.0, "host_ms": 0.0}
        coarse = self.current.get("coarse_correction_batch", none)
        fine = self.current.get("fine_correction_batch", none)
        self.frames.append({
            "bad": res["initial_errors"], "capped": min(res["initial_errors"], kw.get("max_pixels", self.cap)),
            "coarse_n": coarse["n"], "fine_n": fine["n"],
            "coarse_ms": coarse["ms"], "coarse_host_ms": coarse["host_ms"],
            "fine_ms": fine["ms"], "fine_host_ms": fine["host_ms"],
            "rest_host_ms": total - coarse["host_ms"] - fine["host_ms"], "frame_host_ms": total,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "initial_errors": res["initial_errors"], "final_errors": res["final_errors"],
        })
        return res

    def close(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.corr, name, fn)


def ncc_reference(search: np.ndarray, template: np.ndarray) -> np.ndarray:
    """TM_CCOEFF_NORMED with one mean over the template's channels (the
    JAX package's formula), in float64 numpy: window sums from integral
    images, the numerator as an einsum over sliding windows."""
    n, s, _, c = search.shape
    t = template.shape[1]
    o = s - t + 1
    search, template = search.astype(np.float64), template.astype(np.float64)
    tz = template - template.mean(axis=(1, 2, 3), keepdims=True)
    win = np.lib.stride_tricks.sliding_window_view(search, (t, t), axis=(1, 2))     # [n, o, o, c, t, t]
    num = np.einsum("noqcyx,nyxc->noq", win, tz)

    def box(x):
        ii = np.pad(x.sum(-1).cumsum(1).cumsum(2), ((0, 0), (1, 0), (1, 0)))
        return ii[:, t:, t:] - ii[:, :o, t:] - ii[:, t:, :o] + ii[:, :o, :o]

    ssum, ssq = box(search), box(search**2)
    denom = np.sqrt(np.maximum(ssq - ssum**2 / (t * t * c), 0)) * np.sqrt((tz**2).sum(axis=(1, 2, 3)))[:, None, None]
    return np.where(denom > 1e-6, num / np.maximum(denom, 1e-30), 0.0)


def check_ncc_known_answers(dev) -> dict:
    """ncc_match_batch on the card at the correction's full size, under the
    phase's TF32 flags: one channel against cv2.matchTemplate's
    TM_CCOEFF_NORMED (which subtracts each channel's own mean, so only C = 1
    shares the formula) and three channels against ncc_reference, each on
    NCC_PAIRS pairs within NCC_TOL: 0-255 noise search areas, templates cut
    from them at varying offsets, half with noise added."""
    import cv2

    from tpuflow_torch.tools import correction as corr

    rng = np.random.default_rng(SEED + 33)
    s, t = 2 * corr.SEARCH_RADIUS, 2 * corr.TEMPLATE_RADIUS
    out = {}
    for c in (1, 3):
        search = rng.integers(0, 256, (NCC_PAIRS, s, s, c)).astype(np.float32)
        oy, ox = rng.integers(0, s - t, NCC_PAIRS), rng.integers(0, s - t, NCC_PAIRS)
        template = np.stack([search[i, oy[i]:oy[i] + t, ox[i]:ox[i] + t] for i in range(NCC_PAIRS)])
        template[NCC_PAIRS // 2:] += rng.normal(0, 12, template[NCC_PAIRS // 2:].shape).astype(np.float32)
        got = corr.ncc_match_batch(torch.from_numpy(search).to(dev), torch.from_numpy(template).to(dev)).cpu().numpy()
        if c == 1:
            ref = np.stack([cv2.matchTemplate(search[i, ..., 0], template[i, ..., 0], cv2.TM_CCOEFF_NORMED)
                            for i in range(NCC_PAIRS)])
        else:
            ref = ncc_reference(search, template)
        err = float(np.abs(got - ref).max())
        hits = sum(np.unravel_index(got[i].argmax(), got[i].shape) == (oy[i], ox[i]) for i in range(NCC_PAIRS))
        out[f"c{c}"] = {"max_abs_err": err, "argmax_at_cut": int(hits)}
        if err > NCC_TOL or hits < NCC_PAIRS // 2:
            raise AssertionError(f"ncc_match_batch (C = {c}) on the card is {err:.3e} from "
                                 f"{'cv2.matchTemplate' if c == 1 else 'ncc_reference'}; "
                                 f"{hits}/{NCC_PAIRS} peaks at the template's cut")
    log(f"correction NCC known answers ({NCC_PAIRS} pairs of {s}x{s} / {t}x{t} each, TF32 flags at torch's defaults): "
        f"C=1 vs cv2.matchTemplate {out['c1']['max_abs_err']:.2e}, C=3 vs float64 numpy "
        f"{out['c3']['max_abs_err']:.2e} (tolerance {NCC_TOL})")
    return out


def check_known_translation(dev) -> dict:
    """phase_correlate_batch and coarse_correction_batch on a 1920x1080 pair
    whose second frame is the first moved by KNOWN_SHIFT, a texture of
    period 100 = the regions' side (so that every interior region of frame 2
    is a circular shift of frame 1's, as the FFT assumes), at KNOWN_SOURCES
    interior sources: the regions at the same center give the shift, and the
    coarse pass from LOD flows off by up to 10 px in each direction gives the
    flow, each within SHIFT_TOL on at least SHIFT_SHARE of the sources.  The
    same on a texture of white noise (no period), logged and not gated: the
    regions' non-shared borders bias the 5x5 centroid there."""
    from tpuflow_torch.tools import correction as corr

    h, w = MAIN_H, MAIN_W
    dx, dy = KNOWN_SHIFT
    flow = torch.tensor([-dx, -dy], dtype=torch.float32, device=dev)       # target = source - flow
    g = torch.Generator(device=dev).manual_seed(SEED + 34)
    rng = np.random.default_rng(SEED + 35)
    margin = corr.DETAIL_ANALYSIS_REGION_SIZE + 20
    src = torch.from_numpy(np.stack([rng.integers(margin, w - margin, KNOWN_SOURCES),
                                     rng.integers(margin, h - margin, KNOWN_SOURCES)], -1).astype(np.int32)).to(dev)
    lod = flow + torch.from_numpy(rng.integers(-10, 11, (KNOWN_SOURCES, 2)).astype(np.float32)).to(dev)
    out = {}
    for kind in ("periodic", "white"):
        if kind == "periodic":
            tile = torch.randint(0, 256, (100, 100, 3), generator=g, device=dev, dtype=torch.uint8)
            tex = tile.repeat((h + 40) // 100 + 1, (w + 40) // 100 + 1, 1)[: h + 40, : w + 40]
        else:
            tex = torch.randint(0, 256, (h + 40, w + 40, 3), generator=g, device=dev, dtype=torch.uint8)
        f1 = tex[20 : 20 + h, 20 : 20 + w].contiguous()
        f2 = tex[20 - dy : 20 - dy + h, 20 - dx : 20 - dx + w].contiguous()      # f2[y, x] = f1[y - dy, x - dx]
        r = corr.DETAIL_ANALYSIS_REGION_SIZE
        g1, g2 = corr.to_gray(f1.float()), corr.to_gray(f2.float())
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        shift, _ = corr.phase_correlate_batch(corr.extract_regions(g1, src[:, 0], src[:, 1], r),
                                              corr.extract_regions(g2, src[:, 0], src[:, 1], r))
        e[1].record()
        coarse = corr.coarse_correction_batch(f1, f2, src, lod)
        e[2].record()
        torch.cuda.synchronize()
        shift_err = (shift - torch.tensor([dx, dy], dtype=torch.float32, device=dev)).abs().amax(-1)
        flow_err = (coarse["flow"] - flow).abs().amax(-1)
        out[kind] = {"shift_share": float((shift_err <= SHIFT_TOL).float().mean()),
                     "shift_max_err": float(shift_err.max()),
                     "coarse_share": float((flow_err <= SHIFT_TOL).float().mean()),
                     "coarse_max_err": float(flow_err.max()),
                     "phase_ms": e[0].elapsed_time(e[1]), "coarse_ms": e[1].elapsed_time(e[2])}
        del f1, f2, g1, g2, tex, shift, coarse
    p = out["periodic"]
    log(f"correction known translation {KNOWN_SHIFT} at {KNOWN_SOURCES} interior sources of 1080p: "
        + json.dumps(out))
    if p["shift_share"] < SHIFT_SHARE or p["coarse_share"] < SHIFT_SHARE:
        raise AssertionError(f"known translation: phase_correlate_batch within {SHIFT_TOL} px on "
                             f"{p['shift_share']:.4f} of sources, coarse_correction_batch on {p['coarse_share']:.4f} "
                             f"(need {SHIFT_SHARE})")
    return out


def peak_margins(resp: torch.Tensor):
    """(top - second entry, response all zero) of each row of [N, ...]."""
    top2 = resp.reshape(resp.shape[0], -1).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy(), (resp.reshape(resp.shape[0], -1) == 0).all(-1).numpy()


def check_correction_card_vs_cpu(f1: np.ndarray, f2: np.ndarray, flow: np.ndarray, lod: np.ndarray) -> dict:
    """Both passes on PARITY_SOURCES bad pixels of a 1080p pair (the LOD
    vectors as correct_frame takes them) on the card and on the CPU, the fine
    pass from the CPU's coarse targets on both: flows within PARITY_FLOW_TOL
    and similarities within PARITY_SIM_TOL, and the fine pass's integer
    targets equal, on pixels whose peak is clear (PEAK_MARGIN; the CPU's own
    response decides), and, for the coarse pass, whose target is not within
    PARITY_FLOW_TOL of a pixel edge (its truncation picks the pixel that the
    similarity reads).  Counts what each rule leaves out."""
    from tpuflow_torch.pipeline import ops
    from tpuflow_torch.tools import correction as corr

    h, w = f1.shape[:2]
    dev = torch.device("cuda", torch.cuda.current_device())
    qf = ops.quality_frame(*(torch.from_numpy(x) for x in (f1, f2, flow))).numpy()
    bad_y, bad_x = np.where(qf[:, :, 0] > 0)
    pick = np.random.default_rng(SEED + 36).choice(len(bad_y), min(PARITY_SOURCES, len(bad_y)), replace=False)
    by, bx = bad_y[pick], bad_x[pick]
    lh, lw = lod.shape[:2]
    lodv = (lod[np.clip((by * lh) // h, 0, lh - 1), np.clip((bx * lw) // w, 0, lw - 1)]
            / np.array([lw / w, lh / h])).astype(np.float32)
    src = np.stack([bx, by], -1).astype(np.int32)
    cpu = [torch.from_numpy(x) for x in (f1, f2, src, lodv)]
    card = [x.to(dev) for x in cpu]
    res = {"sources": len(src)}
    c_cpu = {k: v.numpy() for k, v in corr.coarse_correction_batch(*cpu).items()}
    c_card = {k: v.cpu().numpy() for k, v in corr.coarse_correction_batch(*card).items()}
    r = corr.DETAIL_ANALYSIS_REGION_SIZE
    g1, g2 = corr.to_gray(cpu[0].float()), corr.to_gray(cpu[1].float())
    lt = cpu[2].float() - cpu[3]
    a = corr.extract_regions(g1, cpu[2][:, 0], cpu[2][:, 1], r)
    b = corr.extract_regions(g2, corr._int32(lt[:, 0]), corr._int32(lt[:, 1]), r)
    fa, fb = torch.fft.rfft2(a), torch.fft.rfft2(b)
    cross = torch.conj(fa) * fb
    margin, flat = peak_margins(torch.fft.irfft2(cross / cross.abs().clamp(min=1e-10), s=(2 * r, 2 * r)))
    frac = np.abs(c_cpu["target"] - np.round(c_cpu["target"])).min(-1)
    clear = (margin > PEAK_MARGIN["phase"]) | flat
    ok = clear & (frac > PARITY_FLOW_TOL)
    res["coarse"] = {"unclear_peak": int((~clear).sum()), "at_pixel_edge": int((clear & ~ok).sum()),
                     "flow_max_err": float(np.abs(c_card["flow"] - c_cpu["flow"])[ok].max(initial=0)),
                     "similarity_max_err": float(np.abs(c_card["similarity"] - c_cpu["similarity"])[ok].max(initial=0)),
                     "integer_targets_equal": bool((np.trunc(c_card["target"]) == np.trunc(c_cpu["target"]))[ok].all())}
    tgt = torch.from_numpy(c_cpu["target"])
    f_cpu = {k: v.numpy() for k, v in corr.fine_correction_batch(cpu[0], cpu[1], cpu[2], tgt).items()}
    f_card = {k: v.cpu().numpy() for k, v in corr.fine_correction_batch(card[0], card[1], card[2], tgt.to(dev)).items()}
    tr, sr = corr.TEMPLATE_RADIUS, corr.SEARCH_RADIUS
    resp = corr.ncc_match_batch(corr.extract_regions(cpu[1].float(), corr._int32(tgt[:, 0]), corr._int32(tgt[:, 1]), sr),
                                corr.extract_regions(cpu[0].float(), cpu[2][:, 0], cpu[2][:, 1], tr))
    margin, flat = peak_margins(resp)
    ok = (margin > PEAK_MARGIN["ncc"]) | flat
    res["fine"] = {"unclear_peak": int((~ok).sum()),
                   "flow_max_err": float(np.abs(f_card["flow"] - f_cpu["flow"])[ok].max(initial=0)),
                   "similarity_max_err": float(np.abs(f_card["similarity"] - f_cpu["similarity"])[ok].max(initial=0)),
                   "integer_targets_equal": bool((f_card["target"] == f_cpu["target"])[ok].all()),
                   "confidence_max_err": float(np.abs(f_card["confidence"] - f_cpu["confidence"])[ok].max(initial=0))}
    log(f"correction card vs CPU on {len(src)} bad pixels of a 1080p pair: " + json.dumps(res))
    for p in ("coarse", "fine"):
        q = res[p]
        if (q["flow_max_err"] > PARITY_FLOW_TOL or q["similarity_max_err"] > PARITY_SIM_TOL
                or not q["integer_targets_equal"]):
            raise AssertionError(f"correction {p} pass: the card differs from the CPU on clear peaks: {q}")
    return res


def trace_correction(dev, f1, f2, flow, lod) -> dict:
    """One frame's correct_frame, capped at TRACE_PIXELS, under
    runtime/profiling.device_trace: its wall time under the profiler, the
    device's busy time, the trace file and the largest kernels.  The trace's
    events grow with the pixels (36 000 at 4096 on an H100), and at the full
    cap parsing them took more than 4 minutes, so the trace takes 4096."""
    import os
    import tempfile

    from tpuflow_torch.runtime.profiling import device_trace
    from tpuflow_torch.tools import correction as corr

    with tempfile.TemporaryDirectory() as logdir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with device_trace(logdir) as prof:
            corr.correct_frame(f1, f2, flow, lod, max_pixels=TRACE_PIXELS, device=dev)
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
        files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        size = os.path.getsize(files[0]) if len(files) == 1 else None
    rows = profile_rows(prof)
    busy = sum(r[0] for r in rows)
    if not rows or size is None:
        raise AssertionError(f"device_trace: {len(rows)} device kernels, trace files {files}")
    log(f"correction trace of frame 0 at {TRACE_PIXELS} pixels (device_trace): wall {traced_ms:.1f} ms with the "
        f"trace written, device busy "
        f"{busy:.1f} ms, trace {size} bytes")
    for ms, count, key in rows[:10]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f} % {count:5d}x  {key[:100]}")
    return {"wall_ms": traced_ms, "device_busy_ms": busy, "trace_bytes": size,
            "top": [[ms, count, key[:100]] for ms, count, key in rows[:10]]}


def phase_correction(kernels) -> dict:
    """The CLI's --interactive --tile (tools/visualizer.launch_interactive)
    on a fresh synthetic 1920x1080 clip of CORRECTION_FRAMES frames, in this
    process, without a display and under torch's default TF32 flags: the
    cache is missing, so it computes the flows (K1 24 and K2 12 launches per
    window), audits the LODs, builds FlowInspector on the card and returns 1
    with the cache statistics.  Then, over that cache, on the card: the
    quality and turbulence maps, analyze_pixel, detail_analysis and
    consistency_check (which must report consistent) at two bad pixels,
    correct_range over every frame at the JAX package's defaults (every pass
    timed, CorrectionClock), check_correction_card_vs_cpu on frame 0's
    pair, the known answers (check_ncc_known_answers,
    check_known_translation), and frame 0's correction traced
    (trace_correction)."""
    import ast
    import os
    import tempfile

    from tpuflow_torch.tools import correction as corr
    from tpuflow_torch.tools import visualizer

    n, h, w = CORRECTION_FRAMES, MAIN_H, MAIN_W
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"frames": n, "shape": [h, w]}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    # torch's own defaults, as a user's process has them: the correction
    # pins its own precision.
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    display = os.environ.pop("DISPLAY", None)
    built = []

    class RecordedInspector(visualizer.FlowInspector):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    original = visualizer.FlowInspector
    visualizer.FlowInspector = RecordedInspector
    clock = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "clip.avi")
            write_clip(clip, n, h, w, SEED + 31)
            os.makedirs(os.path.join(tmp, "out"))
            res = run_cli(kernels, ["--input", clip, "--frames", str(n), "--output", os.path.join(tmp, "out"),
                                    "--tile", "--interactive", "--allow-random-init", "--no-autoplay",
                                    "--uncompressed"])
            text = res["stdout"]
            want = expected_launches(kernels, steps=n * 12, dense_lookup=n * 24, flash_attention_fwd=n * 12)
            if res["launches"] != want:
                raise AssertionError(f"--interactive --tile: kernel launches {res['launches']}, expected {want}")
            for marker in (f"Cache incomplete ({n} frames missing)", "--- LOD Cache Statistics ---",
                           "Cannot start Tk visualizer", "Cache statistics: "):
                if marker not in text:
                    raise AssertionError(f"--interactive: no '{marker}' in its output")
            stats = ast.literal_eval(text.split("Cache statistics: ")[1].splitlines()[0])
            if res["rc"] != 1 or len(built) != 1 or built[0].device.type != "cuda" or stats["frames"] != n \
                    or not stats["complete_lods"]:
                raise AssertionError(f"--interactive: returned {res['rc']}, {len(built)} inspectors "
                                     f"({[str(b.device) for b in built]}), statistics {stats}")
            ins = built[0]
            out["cli"] = {k: v for k, v in cli_summary("--interactive --tile", res, n).items()
                          if k in ("wall_s", "stages_s", "launches", "peak_gib", "rc")}
            out["cli"]["cache_statistics"] = stats

            # The inspector's analyses on the card.
            qm, t_q = timed_call(lambda: ins.quality_map(0))
            tm, t_t = timed_call(lambda: ins.turbulence_map(0))
            bad = np.argwhere(qm[:, :, 0] > 0)
            if qm.shape != (h, w, 3) or tm.shape != (h, w, 3) or not len(bad):
                raise AssertionError(f"inspector maps: {qm.shape}, {tm.shape}, {len(bad)} bad pixels")
            times = {"quality_map_ms": t_q * 1e3, "turbulence_map_ms": t_t * 1e3}
            centre = bad[np.abs(bad - [h // 2, w // 2]).sum(1).argmin()]
            worst = bad[qm[bad[:, 0], bad[:, 1], 0].argmax()]
            for name, (y, x) in (("centre", centre), ("worst", worst)):
                ap, t_a = timed_call(lambda: ins.analyze_pixel(0, int(x), int(y)))
                da, t_d = timed_call(lambda: ins.detail_analysis(0, int(x), int(y)))
                cc, t_c = timed_call(lambda: ins.consistency_check(0, int(x), int(y)))
                if not cc["consistent"] or not np.isfinite(da["corrected_flow"]).all():
                    raise AssertionError(f"inspector at {name} pixel ({x}, {y}): consistency {cc['consistent']} "
                                         f"(target delta {cc['target_delta']}), corrected flow {da['corrected_flow']}")
                times[name] = {"pixel": [int(x), int(y)], "analyze_pixel_ms": t_a * 1e3,
                               "detail_analysis_ms": t_d * 1e3, "consistency_check_ms": t_c * 1e3,
                               "fine": ap["fine"] is not None,
                               "corrected_similarity": da["corrected_similarity"]}
            out["inspector"] = times
            out["bad_share_frame0"] = float(len(bad) / (h * w))
            log(f"correction inspector on the card: {json.dumps(times)}; bad pixels of frame 0: {len(bad)}")

            # Every frame corrected at the defaults, each pass timed.
            clock = CorrectionClock()
            results, wall = timed_call(lambda: ins.correct_range(0, n, progress=False))
            clock.close()
            frames_log, clock = clock.frames, None
            if len(results) != n or len(frames_log) != n:
                raise AssertionError(f"correct_range: {len(results)} results, {len(frames_log)} frames timed")
            for i, r in enumerate(results):
                saved = corr.FlowFileHandler.load_flow_npz(r["path"])["flow"]
                if saved.shape != (h, w, 2) or not np.isfinite(saved).all() or not np.array_equal(saved, r["flow"]):
                    raise AssertionError(f"correct_range frame {i}: {r['path']} holds {saved.shape}, finite "
                                         f"{np.isfinite(saved).all()}, equal to the result "
                                         f"{np.array_equal(saved, r['flow'])}")
                log(f"correction frame {i}: " + json.dumps(frames_log[i]))
            out["correct_range"] = {"wall_s": wall, "frames": frames_log}

            lod = ins.lod_cache.get((0, 4))
            pair = (ins.frames[0], ins.frames[1], ins.load_flow(0), lod)
            out["parity"] = check_correction_card_vs_cpu(*pair[:3], lod if lod is not None else pair[2])
            del ins, built[:]
        torch.cuda.empty_cache()
        out["ncc_known"] = check_ncc_known_answers(dev)
        out["known_translation"] = check_known_translation(dev)
        out["trace"] = trace_correction(dev, *pair)
    finally:
        if clock is not None:
            clock.close()
        visualizer.FlowInspector = original
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        if display is not None:
            os.environ["DISPLAY"] = display
    torch.cuda.empty_cache()
    return out


DP_SLOTS = 2                      # replicas of the data-parallel phase, both on the one card
DP_UNTILED = (0, 2, 5)            # frames whose untiled windows compute_flow_batch runs under the mesh
STRIDED_FRAMES = 7                # untiled frames of the data-parallel compute_flows_strided


def phase_data_parallel(engine, kernels) -> dict:
    """FlowEngine(mesh=) over a Mesh that lists the card DP_SLOTS times (the
    script needs one card only), on the main engine's weights at the product
    configuration: compute_flows_tiled_stride1 on MAIN_FRAMES 1080p frames
    with window_batch 2 (one window per replica: bit for bit the one-replica
    engine's window_batch 1), compute_flow_batch on the three untiled 1080p
    windows of DP_UNTILED (padded to four: K3 and K2 at S = 32 400 per
    replica; the first replica's two windows bit for bit a one-replica
    batch of the same two, all three within the bf16 limits of one batch of
    three), and compute_flows_strided on STRIDED_FRAMES frames (three
    windows padded to four, one per replica per batch: bit for bit the
    one-replica window_batch 1).  Counters zeroed just before each mesh call
    and read just after.  PipelineConfig(data_parallel=2) builds a mesh of
    min(2, cards) cards, none on one card.  Two replicas on one card run one
    after the other: these numbers show correctness, not a speed-up."""
    from tpuflow_torch.config import PipelineConfig
    from tpuflow_torch.runtime.engine import FlowEngine
    from tpuflow_torch.runtime.sharding import Mesh
    from tpuflow_torch.tools.pipeline import FlowPipeline

    cfg = engine.config
    cards = torch.cuda.device_count()
    pipe_mesh = FlowPipeline(PipelineConfig(data_parallel=DP_SLOTS), engine=None).engine.mesh
    if (pipe_mesh is None) != (cards == 1) or (pipe_mesh is not None and pipe_mesh.shape != {"data": 2}):
        raise AssertionError(f"data parallel: PipelineConfig(data_parallel=2) on {cards} cards built {pipe_mesh}")
    mesh = FlowEngine(cfg, seed=SEED, params=engine.model.state_dict(), mesh=Mesh([engine.device] * DP_SLOTS))
    mesh.load_model()
    note = f"{DP_SLOTS} replicas on one card run one after the other: correctness, not a speed-up"
    out = {"slots": DP_SLOTS, "note": note, "pipeline_mesh_on_one_card": pipe_mesh is None}

    def mesh_call(what, fn, frames_done, want):
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        flows, wall = timed_call(fn)
        launches = read_launches(kernels)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not np.isfinite(flows).all():
            raise AssertionError(f"data parallel {what}: flows not finite")
        if launches != want:
            raise AssertionError(f"data parallel {what}: kernel launches {launches}, expected {want}")
        log(f"data parallel {what}: {frames_done} frames in {wall:.3f} s = {frames_done / wall:.4f} frames/s, "
            f"peak {peak:.2f} GiB, launches {launches} ({note})")
        return flows, {"wall_s": wall, "frames_per_s": frames_done / wall, "peak_gib": peak, "launches": launches}

    frames = synthetic_clip(MAIN_FRAMES, MAIN_H, MAIN_W, SEED)
    ref, ref_wall = timed_call(lambda: engine.compute_flows_tiled_stride1(frames))
    depth = cfg.decoder_depth
    flows, out["tiled"] = mesh_call(
        "tiled stride-1, window_batch 2", lambda: mesh.compute_flows_tiled_stride1(frames, window_batch=2),
        MAIN_FRAMES, expected_launches(kernels, steps=MAIN_FRAMES * depth, dense_lookup=MAIN_FRAMES * 2 * depth,
                                       flash_attention_fwd=MAIN_FRAMES * depth))
    out["tiled"]["one_replica_wall_s"] = ref_wall
    if not np.array_equal(flows, ref):
        raise AssertionError(f"data parallel tiled: not bit for bit the one-replica engine's (max |diff| "
                             f"{np.abs(flows - ref).max()})")
    out["tiled"]["bit_equal_one_replica"] = True

    idx = list(DP_UNTILED)
    ref = engine.compute_flow_batch(frames, idx)
    pair = engine.compute_flow_batch(frames, idx[:2])
    per_batch = dict(flash2_patch_level=2 * depth * cfg.corr_levels, flash_attention_fwd=depth)
    flows, out["untiled"] = mesh_call(
        f"compute_flow_batch, {len(idx)} untiled windows padded to 4", lambda: mesh.compute_flow_batch(frames, idx),
        len(idx), expected_launches(kernels, steps=depth * DP_SLOTS, **{k: v * DP_SLOTS for k, v in per_batch.items()}))
    if not np.array_equal(flows[:2], pair):
        raise AssertionError("data parallel untiled: the first replica's two windows are not a one-replica "
                             "batch of the same two, bit for bit")
    out["untiled"]["first_replica_bit_equal"] = True
    out["untiled"]["vs_one_batch_of_three"] = check_flows_agree("data parallel untiled vs one batch of three",
                                                                flows, ref)

    strided = synthetic_clip(STRIDED_FRAMES, MAIN_H, MAIN_W, SEED + 7)
    windows = len(range(-1, STRIDED_FRAMES - 1, cfg.sequence_length - 2))
    dispatches = math.ceil(windows / DP_SLOTS) * DP_SLOTS
    ref = engine.compute_flows_strided(strided, window_batch=1)
    flows, out["strided"] = mesh_call(
        f"compute_flows_strided, {windows} windows, window_batch 2",
        lambda: mesh.compute_flows_strided(strided, window_batch=2), STRIDED_FRAMES,
        expected_launches(kernels, steps=depth * dispatches, **{k: v * dispatches for k, v in per_batch.items()}))
    if not np.array_equal(flows, ref):
        raise AssertionError(f"data parallel strided: not bit for bit the one-replica window_batch 1 "
                             f"(max |diff| {np.abs(flows - ref).max()})")
    out["strided"]["bit_equal_one_replica"] = True
    usage = mesh.get_memory_usage()
    if list(usage) != [f"cuda:{engine.device.index}"]:
        raise AssertionError(f"data parallel: get_memory_usage reports {list(usage)}")
    out["memory_usage"] = usage
    del mesh
    torch.cuda.empty_cache()
    return out


SPATIAL_SLOTS = 4                 # 'spatial' slots of the 1080p window, all on the one card
SPATIAL_SMALL = (480, 640)        # H, W of the two windows of the ('data' 2, 'spatial' 2) run
SPATIAL_SMALL_IDX = (2, 5)        # their centre frames, of a clip of SPATIAL_SMALL_FRAMES
SPATIAL_SMALL_FRAMES = 8


def spatial_run(engine, kernels, mesh, windows: np.ndarray, want: dict, what: str):
    """shard_spatial_forward of the engine's model over `mesh` on uint8
    windows [B, T, H, W, 3] (uploaded as the engine uploads them), counters
    zeroed just before and read just after, the card's peak memory over the
    call.  Returns (the middle interior frame's forward flows [B, H, W, 2] as
    numpy, a dict of numbers)."""
    from tpuflow_torch.runtime.sharding import shard_spatial_forward

    sharded = shard_spatial_forward(engine.model, mesh, 5, 2)
    params = engine.model.state_dict()
    x = torch.from_numpy(windows).to(engine.device).float() / 255.0
    with torch.inference_mode():
        sharded(params, x)                                     # warm-up
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        (fwd, _), wall = timed_call(lambda: sharded(params, x))
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    flows = fwd[:, fwd.shape[1] // 2].float().cpu().numpy()
    fetched = sum(sum(g.fetched_bytes) for g in sharded.groups)
    if flows.shape != (windows.shape[0], *windows.shape[2:4], 2) or not np.isfinite(flows).all():
        raise AssertionError(f"spatial {what}: bad flows, shape {flows.shape}")
    if fwd.device != engine.device:
        raise AssertionError(f"spatial {what}: flows on {fwd.device}, not the mesh's first device")
    if launches != want:
        raise AssertionError(f"spatial {what}: kernel launches {launches}, expected {want}")
    rows = sharded.groups[0].rows
    log(f"spatial {what}: strips of {rows} feature rows, {wall:.3f} s, card peak {peak:.2f} GiB, "
        f"{fetched / 1e6:.1f} MB fetched between strips, launches {launches}")
    return flows, {"strip_rows": rows, "wall_s": wall, "card_peak_gib": peak,
                   "bytes_between_strips": fetched, "launches": launches}


def phase_spatial(engine, kernels) -> dict:
    """shard_spatial_forward (runtime/sharding.py) at the product
    configuration on the main engine's weights, over meshes that list the
    one card several times (each slot's strip runs in a host thread of its
    own; on one card they share it, so these numbers show correctness, and
    the card's peak is the strips' together; chip_multicard.py puts one
    strip on each card):
    - ('data' 1, 'spatial' 4) on one untiled 1920x1080 window (T = 5): the
      /8 grid's 135 rows in strips of 34, 34, 34 and 33; 'auto' decides on
      the whole 135x240 grid, so each strip runs FlashCorr2 (K3 96 and K2
      12 launches per strip, GMA from the strip's queries to the frame's
      32 400 keys), held to the engine's compute_flow of the same window
      within FLOW_MEAN_LIMIT / FLOW_MAX_LIMIT;
    - ('data' 2, 'spatial' 2) on two untiled 640x480 windows: a 60x80 grid,
      so each strip materializes a dense volume of its own 30 rows' queries
      and K1 looks it up from row0 = 0 or 30 (24 launches per strip), held
      to compute_flow_batch of the same two windows."""
    from tpuflow_torch.runtime.sharding import Mesh
    from tpuflow_torch.runtime.windows import centered_window_indices

    cfg, dev = engine.config, engine.device
    t, depth = cfg.sequence_length, cfg.decoder_depth
    out = {"note": "the strips share one card: correctness, not a speed-up"}

    frames = synthetic_clip(t, MAIN_H, MAIN_W, SEED + 5)
    engine.compute_flow(frames, t // 2)                        # warm-up
    ref, ref_wall = timed_call(lambda: engine.compute_flow(frames, t // 2))
    want = expected_launches(kernels, steps=SPATIAL_SLOTS * depth,
                             flash2_patch_level=SPATIAL_SLOTS * 2 * depth * cfg.corr_levels,
                             flash_attention_fwd=SPATIAL_SLOTS * depth)
    mesh = Mesh([[dev] * SPATIAL_SLOTS], ("data", "spatial"))
    flows, out["untiled_1080p"] = spatial_run(engine, kernels, mesh, frames[None], want,
                                              f"1080p window over {SPATIAL_SLOTS} strips")
    out["untiled_1080p"]["one_card_compute_flow_wall_s"] = ref_wall
    out["untiled_1080p"].update(check_flows_agree("spatial 1080p vs compute_flow", flows[0], ref))

    h, w = SPATIAL_SMALL
    clip = synthetic_clip(SPATIAL_SMALL_FRAMES, h, w, SEED + 11)
    windows = np.stack([clip[centered_window_indices(len(clip), i, t)] for i in SPATIAL_SMALL_IDX])
    ref = engine.compute_flow_batch(clip, list(SPATIAL_SMALL_IDX))
    want = expected_launches(kernels, steps=4 * depth, dense_lookup=4 * 2 * depth, flash_attention_fwd=4 * depth)
    mesh = Mesh([[dev] * 2] * 2, ("data", "spatial"))
    flows, out["untiled_640x480"] = spatial_run(engine, kernels, mesh, windows, want,
                                                f"two {w}x{h} windows, ('data' 2, 'spatial' 2)")
    out["untiled_640x480"].update(check_flows_agree("spatial 640x480 vs compute_flow_batch", flows, ref))
    out["strip_probes"] = strip_probes(engine, frames, windows)
    torch.cuda.empty_cache()
    return out


def strip_probes(engine, frames: np.ndarray, windows: np.ndarray) -> dict:
    """The strips' kernels on the model's own features, against the
    unsharded window's rows.  With random weights the flow hardly depends on
    the lookups (check_lookups_agree), so the flows above would not show a
    strip that looks up or attends from the wrong rows:
    - K1 from row0: each ('spatial' 2) strip's DenseCorrPyramid of the
      640x480 window (its queries' planes of the frame's targets) looked
      up at probe flows from its row0, bit for bit the unsharded lookup's
      rows (the same taps, the same arithmetic);
    - K2 with Sq != Sk: each ('spatial' 4) strip's GMA queries of the 1080p
      window (GMA q, k and the context as v) against the frame's 32 400
      keys, held to the unsharded call's rows within K2's own tolerance
      (2^-7 of softmax(qk^T)|v|; measured bit for bit)."""
    from tpuflow_torch.core.corr import DenseCorrPyramid
    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain
    from tpuflow_torch.runtime.sharding import shard_sizes

    model, dev = engine.model, engine.device
    out = {}
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(windows).to(dev).float() / 255.0)
        bn, h8, w8, _ = enc.net.shape
        probe = probe_flow(dev, bn, h8, w8, SEED + 12)
        full = model._lookup(enc.corr_fwd, probe)
        start = 0
        for rows in shard_sizes(h8, 2):
            sub = DenseCorrPyramid([v.reshape(bn, h8, w8, *v.shape[1:])[:, start : start + rows].reshape(
                -1, *v.shape[1:]).contiguous() for v in enc.corr_fwd.pyramid], row0=start)
            got = model._lookup(sub, probe[:, start : start + rows].contiguous())
            if not torch.equal(got, full[:, start : start + rows]):
                raise AssertionError(f"strip probe: K1 from row0 {start} is not the unsharded lookup's rows "
                                     f"(max |diff| {(got - full[:, start : start + rows]).abs().max().item()})")
            start += rows
        log(f"strip probe: K1 from each strip's row0 of a {h8}x{w8} grid, bit for bit the unsharded rows")
        out["k1_row0_bit_equal"] = True
        del enc, full, sub

        enc = model.encode(torch.from_numpy(frames[None]).to(dev).float() / 255.0)
        bn, h8, w8, d = enc.q.shape
        q, k, v = (t.reshape(bn, h8 * w8, d).to(model.dtype).contiguous() for t in (enc.q, enc.k, enc.inp))
        full = flash_attention_fwd(q, k, v)
        scale = flash_attention_plain(q.float(), k.float(), v.float().abs())
        worst, start, bitwise = 0.0, 0, True
        for rows in shard_sizes(h8, SPATIAL_SLOTS):
            sl = slice(start * w8, (start + rows) * w8)
            got = flash_attention_fwd(q[:, sl].contiguous(), k, v)
            bitwise = bitwise and torch.equal(got, full[:, sl])
            worst = max(worst, ((got.float() - full[:, sl].float()).abs() / (1e-5 + scale[:, sl])).max().item())
            start += rows
        log(f"strip probe: K2 from each of {SPATIAL_SLOTS} strips' queries to the {h8 * w8} keys: max |strip - "
            f"unsharded| = {worst:.3e} of softmax(qk^T)|v| (limit 2^-7), bit for bit: {bitwise}")
        if not worst <= 2**-7:
            raise AssertionError(f"strip probe: K2 from a strip's queries disagrees with the unsharded rows: {worst}")
        out["k2_strip_vs_unsharded_scale"] = worst
        out["k2_bit_equal"] = bitwise
    return out


def phase_checkpoint(engine) -> dict:
    """Native checkpoints: save_params of the main engine's weights (bf16 on
    the card, written as the JAX package's float32 flax tree), load_model of
    that file into a fresh engine: the same weights and the same flows on a
    640x480 clip, bit for bit; then `python3 -m tpuflow_torch.runtime.checkpoint
    IN.pth OUT.msgpack` on a .pth of the weights in f32 (a process of its
    own, on the card): the file holds the .pth's weights exactly."""
    import os
    import tempfile

    from tpuflow_torch.runtime.checkpoint import load_params, save_params
    from tpuflow_torch.runtime.engine import FlowEngine

    h, w = SINGLE_TILE_HW
    frames = synthetic_clip(5, h, w, SEED + 30)
    state = engine.model.state_dict()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mof.msgpack")
        _, out["save_s"] = timed_call(lambda: save_params(path, state))
        out["file_mb"] = os.path.getsize(path) / 1e6
        fresh = FlowEngine(engine.config, seed=SEED + 99)
        _, out["load_s"] = timed_call(lambda: fresh.load_model(path))
        same = all(torch.equal(v, state[k]) for k, v in fresh.model.state_dict().items())
        a, b = engine.compute_flow(frames, 2), fresh.compute_flow(frames, 2)
        if not (same and np.array_equal(a, b)):
            raise AssertionError(f"checkpoint: reloaded weights equal {same}, flows max |diff| {np.abs(a - b).max()}")
        del fresh
        pth, dst = os.path.join(tmp, "mof.pth"), os.path.join(tmp, "converted.msgpack")
        f32 = {k: v.float().cpu() for k, v in state.items()}
        torch.save(f32, pth)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "tpuflow_torch.runtime.checkpoint", pth, dst],
                             capture_output=True, text=True, timeout=600)
        out["convert_process_s"] = time.perf_counter() - t0
        if res.returncode != 0 or "converted" not in res.stdout:
            raise AssertionError(f"checkpoint main failed: {res.stdout[-1500:]} {res.stderr[-1500:]}")
        got = load_params(dst, f32)
        if not all(torch.equal(got[k], v) for k, v in f32.items()):
            raise AssertionError("checkpoint main: the native file does not hold the .pth's weights")
    log(f"checkpoint: {out['file_mb']:.1f} MB, save {out['save_s']:.3f} s, load {out['load_s']:.3f} s, "
        f"conversion process {out['convert_process_s']:.1f} s; weights and flows bit for bit")
    out["bit_equal"] = True
    torch.cuda.empty_cache()
    return out


DIST_FRAMES = 6                   # 1080p frames of the two-process --tile flow pass
DIST_MEMFLOW = (8, 480, 640)      # frames, H, W of the two-process MemFlow pass
DIST_TIMEOUT = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_process_cli(video: str, out_dir: str, n: int, extra) -> list:
    """Two `python3 -m tpuflow_torch.tools.cli ... --num-processes 2` processes
    on the card (both on cuda:0 over gloo), started together; returns their
    (output, wall s), each waited for within DIST_TIMEOUT."""
    import os

    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "tpuflow_torch.tools.cli", "--input", video, "--frames", str(n),
               "--output", out_dir, "--allow-random-init", "--skip-lods", "--no-autoplay", *extra,
               "--coordinator", coord, "--num-processes", "2", "--process-id", str(pid)]
        procs.append((subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                      time.perf_counter()))
    results = []
    try:
        for proc, t0 in procs:
            text = proc.communicate(timeout=DIST_TIMEOUT)[0]
            results.append((text, time.perf_counter() - t0))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for (proc, _), (text, _) in zip(procs, results):
        if proc.returncode != 0:
            raise AssertionError(f"distributed CLI process failed:\n{text[-3000:]}")
    return results


def cached_flows(pipe, video: str, n: int) -> np.ndarray:
    from tpuflow_torch.pipeline.cache import FlowCacheManager

    cache = pipe.cache_dir_for(video, 0, n)
    mgr = FlowCacheManager()
    ok, fmt, missing = mgr.check_cache_exists(cache, n)
    if not ok:
        raise AssertionError(f"distributed: cache {cache} incomplete ({fmt}, missing {missing})")
    return np.stack([mgr.load_cached_flow(cache, i, fmt) for i in range(n)])


def phase_distributed(kernels) -> dict:
    """The multi-process flow pass on the card: two CLI processes
    (--num-processes 2 --tile, both on cuda:0 over gloo) on a 1920x1080 clip
    of DIST_FRAMES frames, each its own range; then one process's
    compute_flows_distributed on a copy of the clip (the whole range, in this
    process, counters zeroed before and read after): the union cache is
    complete and its flows within the bf16 limits of the one process's (bit
    equality reported).  Then --model memflow the same way on DIST_MEMFLOW:
    the warm-up prefix reaches frame 0, so the union cache equals the one
    stream bit for bit.  Each process's wall on the host clock."""
    import os
    import shutil
    import tempfile

    from tpuflow_torch.config import PipelineConfig
    from tpuflow_torch.tools.pipeline import FlowPipeline

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for what, (n, h, w), extra, kw in (
            ("tile", (DIST_FRAMES, MAIN_H, MAIN_W), ["--tile"], dict(tile=True)),
            ("memflow", DIST_MEMFLOW, ["--model", "memflow"], dict(model="memflow")),
        ):
            video = os.path.join(tmp, f"{what}.avi")
            write_clip(video, n, h, w, SEED + 40)
            single = os.path.join(tmp, f"{what}_single.avi")
            shutil.copy(video, single)
            os.makedirs(os.path.join(tmp, what), exist_ok=True)
            results = two_process_cli(video, os.path.join(tmp, what), n, extra)
            for pid, (text, _) in enumerate(results):
                if f"{n}/{n} flows complete" not in text:
                    raise AssertionError(f"distributed {what}: process {pid} did not see the whole count:\n"
                                         f"{text[-2000:]}")
            owned = [line.split("own flows ")[1] for text, _ in results for line in text.splitlines()
                     if "own flows" in line]
            pipe = FlowPipeline(PipelineConfig(input=single, frames=n, allow_random_init=True, skip_lods=True, **kw))
            reset_launches(kernels)
            _, one_wall = timed_call(pipe.compute_flows_distributed)
            launches = read_launches(kernels)
            dist = cached_flows(pipe, video, n)
            ref = cached_flows(pipe, single, n)
            res = {"frames": n, "shape": [h, w], "owned": owned, "process_wall_s": [t for _, t in results],
                   "one_process_wall_s": one_wall, "one_process_launches": launches,
                   "bit_equal": bool(np.array_equal(dist, ref))}
            if what == "tile":
                depth = pipe.engine.config.decoder_depth
                want = expected_launches(kernels, steps=n * depth, dense_lookup=n * 2 * depth,
                                         flash_attention_fwd=n * depth)
                if launches != want:
                    raise AssertionError(f"distributed tile: launches {launches}, expected {want}")
                res["vs_one_process"] = check_flows_agree("distributed --tile vs one process", dist, ref)
            else:
                if not any("memory warm-up" in text for text, _ in results):
                    raise AssertionError("distributed memflow: no process logged its memory warm-up")
                if not res["bit_equal"]:
                    raise AssertionError(f"distributed memflow: not bit for bit the one stream (max |diff| "
                                         f"{np.abs(dist - ref).max()})")
            log(f"distributed {what}: {n} frames of {w}x{h}, owned {owned}, process walls "
                f"{[round(t, 3) for t in res['process_wall_s']]} s, one process {one_wall:.3f} s, "
                f"bit equal {res['bit_equal']}")
            out[what] = res
            del pipe
            torch.cuda.empty_cache()
    return out


TRAIN_HW = (368, 496)             # RAFT's FlyingChairs crop
TRAIN_STEPS = 3
TRAIN_WINDOWS = 2
TRAIN_NARROW = dict(encoder="cnn", corr_levels=2, corr_radius=2, decoder_depth=2, feature_dim=64)
TRAIN_NARROW_HW = (64, 96)
# Card against CPU, one step at the narrow width in f32 with TF32 off: the
# loss within 1e-4 relative, each gradient within 5e-3 of its tensor's
# largest |gradient| plus 1e-6 (sums in another order, through two
# iterations; a gradient that is lost or wrong is off by its own size).
# The same bounds hold shard_train_step over two replicas on a ragged batch
# (2 + 1 windows) to one step on the whole batch, on the card: an average
# not weighted by shard size is off by a sixth of the gradients.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_SHARE = 5e-3


def train_batch(dev, b: int, t: int, h: int, w: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    windows = torch.rand((b, t, h, w, 3), generator=g)
    targets = torch.randn((b, h, w, 2), generator=g) * 4.0
    return windows.to(dev), targets.to(dev)


def phase_train(kernels, dev) -> dict:
    """The train step on the card: the product configuration (Twins, 4
    levels, radius 4, 12 iterations, T=5, published widths) in f32 with f32
    volumes, dense_lookup='xla' and gma_impl='xla', at TRAIN_HW; TRAIN_STEPS
    steps of shard_train_step over a mesh that lists the card twice, with
    TRAIN_WINDOWS windows (one per replica) and AdamW(lr=1e-4,
    weight_decay=1e-4, eps=1e-8), under torch's default TF32 flags (cuDNN
    may use TF32, matmuls do not), logged: finite losses, every trained
    parameter moved, ms per step by CUDA events and peak memory, and K7's
    launches (PCBlock4's forward; its backward is the plain twin's).  Then a
    backward with dense_lookup='auto' (K1) and with gma_impl='flash' (K2)
    raises the kernels' refusal; then one step at a narrow width on the card
    and on the CPU with TF32 off, and on the card shard_train_step over two
    replicas on a ragged batch against one step on the whole batch: the loss
    and every gradient within TRAIN_LOSS_TOL and TRAIN_GRAD_SHARE."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.core.mofnet import MOFNet
    from tpuflow_torch.runtime.engine import FlowEngine, init_random_
    from tpuflow_torch.runtime.sharding import Mesh, make_train_step, shard_train_step, window_loss

    engine = FlowEngine(ModelConfig(), seed=SEED + 50, device=dev, dtype=torch.float32, dense_lookup="xla")
    engine.model.corr_dtype = torch.float32
    engine.model.gma_impl = "xla"
    engine.load_model(allow_random_init=True)
    model = engine.model
    del engine
    h, w = TRAIN_HW
    t = ModelConfig().sequence_length
    windows, targets = train_batch(dev, TRAIN_WINDOWS, t, h, w, SEED + 51)
    start = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = shard_train_step(make_train_step(model, opt), Mesh([dev] * DP_SLOTS))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False   # torch's defaults
    tf32 = {"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": False}
    losses, ms = [], []
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(TRAIN_STEPS):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            loss = step(windows, targets)
            t1.record()
            t1.synchronize()
            ms.append(t0.elapsed_time(t1))
            losses.append(loss.item())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches(kernels)
    moved = sum(int(not torch.equal(p, s)) for p, s in zip(model.parameters(), start))
    trained = sum(1 for p in model.parameters() if p.grad is not None and p.grad.abs().max() > 0)
    log(f"train: {TRAIN_STEPS} steps of {TRAIN_WINDOWS} windows of {t}x{w}x{h} over {DP_SLOTS} replicas on one "
        f"card, f32, TF32 flags {tf32}: losses {losses}, ms per step {[round(m, 2) for m in ms]}, peak "
        f"{peak:.2f} GiB, {moved} of {len(start)} parameters moved ({trained} with a gradient), launches {launches}")
    if not all(math.isfinite(v) for v in losses) or moved < trained or trained < len(start) - 1:
        raise AssertionError(f"train: losses {losses}, {moved} parameters moved, {trained} with a gradient")
    # The plain formulations of K1 and K2; K7 forward (its backward is its plain twin's).
    want = expected_launches(kernels, steps=TRAIN_STEPS * DP_SLOTS * model.decoder_depth)
    if launches != want:
        raise AssertionError(f"train: kernel launches {launches}, expected {want}")
    out = {"crop": [h, w], "windows": TRAIN_WINDOWS, "replicas": DP_SLOTS, "losses": losses, "ms_per_step": ms,
           "peak_gib": peak, "tf32_flags": tf32, "parameters_moved": moved, "parameters": len(start)}
    del step, opt, start

    refused = {}
    for attr, value, kernel in (("dense_lookup", "auto", "dense_lookup"), ("gma_impl", "flash", "flash_attention_fwd")):
        setattr(model, attr, value)
        reset_launches(kernels)
        loss = window_loss(model, windows[:1], targets[:1])
        try:
            loss.backward()
        except RuntimeError as exc:
            if not str(exc).startswith(f"{kernel} has no backward") or "dense_lookup='xla'" not in str(exc):
                raise
            refused[kernel] = {"error": str(exc), "launches": read_launches(kernels)[kernel]}
        else:
            raise AssertionError(f"train: a backward through {kernel} ({attr}={value!r}) did not raise")
        setattr(model, attr, "xla")
    log(f"train: the kernels refuse a gradient: {json.dumps(refused)}")
    out["refused"] = refused
    model.zero_grad(set_to_none=True)
    del model, loss
    torch.cuda.empty_cache()

    nh, nw = TRAIN_NARROW_HW

    def narrow_step(on, b, mesh=None):
        """(loss, {name: gradient on the CPU}) of one SGD step of the narrow
        model on b seeded windows, on `on`, through shard_train_step when a
        mesh is given."""
        narrow = MOFNet(corr_dtype=torch.float32, dense_lookup="xla", gma_impl="xla", **TRAIN_NARROW)
        init_random_(narrow, SEED + 52)
        narrow = narrow.to(on)
        one = make_train_step(narrow, torch.optim.SGD(narrow.parameters(), lr=0.0))
        loss = (shard_train_step(one, mesh) if mesh is not None else one)(*train_batch(on, b, 3, nh, nw, SEED + 53))
        return loss.item(), {k: p.grad.detach().cpu() for k, p in narrow.named_parameters()}

    def compare(what, got, ref) -> dict:
        (loss_a, ga), (loss_b, gb) = got, ref
        worst = max(((ga[k] - g).abs().max() / (g.abs().max() + 1e-6)).item() for k, g in gb.items())
        bad = [k for k, g in gb.items() if (ga[k] - g).abs().max() > TRAIN_GRAD_SHARE * g.abs().max() + 1e-6]
        rel = abs(loss_a - loss_b) / abs(loss_b)
        log(f"train {what}, narrow ({TRAIN_NARROW}, {nw}x{nh}), TF32 off: losses {loss_a} and {loss_b}, relative "
            f"{rel:.3e}; worst gradient share {worst:.3e} (limit {TRAIN_GRAD_SHARE:g}) over {len(gb)} tensors")
        if rel > TRAIN_LOSS_TOL or bad or set(ga) != set(gb):
            raise AssertionError(f"train {what}: loss relative {rel}, gradients off in {bad[:5]}")
        return {"losses": [loss_a, loss_b], "loss_rel": rel, "worst_grad_share": worst}

    out["card_vs_cpu"] = compare("card vs cpu", narrow_step(dev, 2), narrow_step(torch.device("cpu"), 2))
    out["ragged_vs_whole"] = compare("shard_train_step 2 + 1 vs the whole batch", narrow_step(dev, 3, Mesh([dev] * 2)),
                                     narrow_step(dev, 3))
    torch.cuda.empty_cache()
    return out


def kernel_counters() -> dict:
    """The nine kernels' wrappers by name; each counts its launches."""
    from tpuflow_torch.kernels.bandlookup import band_patch_level
    from tpuflow_torch.kernels.denselookup import dense_lookup, dense_patch_level
    from tpuflow_torch.kernels.depthwise import depthwise_residual_gelu
    from tpuflow_torch.kernels.flashattn import flash_attention_fwd
    from tpuflow_torch.kernels.flashcorr import flash_patch_level
    from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level
    from tpuflow_torch.kernels.memread import memory_read
    from tpuflow_torch.kernels.pointwise import pointwise_gemm

    return {fn.__name__: fn for fn in (dense_lookup, flash_attention_fwd, flash2_patch_level,
                                       dense_patch_level, flash_patch_level, band_patch_level,
                                       depthwise_residual_gelu, pointwise_gemm, memory_read)}


def main() -> int:
    smi = phase_environment()
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        from tpuflow_torch.config import ModelConfig
        from tpuflow_torch.kernels.flashcorr import flash_patch_level, flash_patch_level_plain
        from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level, flash2_patch_level_plain
        from tpuflow_torch.runtime.engine import FlowEngine
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: run from the repository root ({exc})")
    kernels = kernel_counters()

    # The checked build runs in a child process while this one builds.
    child = phase_checked_start()
    try:
        phase_build()
    finally:
        checked = phase_checked_wait(child)
    rows = [
        check_dense_lookup(dev),
        check_flash_attention(dev),
        check_corr_patch(dev, flash2_patch_level, flash2_patch_level_plain, "tpuflow/kernels/flashcorr2.py:246",
                         memflow=True),
        check_volume_patch(dev, "flat"),
        # On the 'flash' path K5 sees level 0 of the tile shape only.
        check_corr_patch(dev, flash_patch_level, flash_patch_level_plain, "tpuflow/kernels/flashcorr.py:157",
                         also=(TILE_QUERIES, 1)),
        check_volume_patch(dev, "band"),
    ]
    far = check_volume_patch_far(dev)
    depthwise = check_depthwise(dev)
    pointwise = check_pointwise(dev)
    memread = check_memory_read(dev)
    for row in rows:
        if row["name"] in ("dense_patch_level", "band_patch_level"):
            row["farthest_entry_checked"] = far["flat" if row["name"] == "dense_patch_level" else "band"]
    torch.cuda.empty_cache()

    engine = FlowEngine(ModelConfig(), seed=SEED)          # device defaults to the card
    log("weights:", engine.load_model(allow_random_init=True), "dtype", engine.model.dtype)
    e2e = phase_end_to_end(engine, kernels)
    torch.cuda.empty_cache()
    untiled = phase_untiled(engine, kernels)
    torch.cuda.empty_cache()
    strided = phase_strided(engine, kernels)
    torch.cuda.empty_cache()
    forms = phase_formulations(engine, kernels)
    torch.cuda.empty_cache()
    batching = phase_window_batch(engine, kernels)
    torch.cuda.empty_cache()
    uhd = phase_uhd(engine, kernels)
    single = phase_single_tile(engine)
    dp = phase_data_parallel(engine, kernels)
    spatial = phase_spatial(engine, kernels)
    ckpt = phase_checkpoint(engine)
    del engine
    torch.cuda.empty_cache()
    bof = phase_bof(kernels)
    cnn = phase_cnn(kernels, e2e["stages_ms"]["features_per_frame"])
    memflow = phase_memflow(kernels)
    parity = phase_parity(kernels)
    pipeline = phase_pipeline(kernels, {"tiled": e2e["frames_per_s"], "memflow": memflow["frames_per_s"]})
    correction = phase_correction(kernels)
    distributed = phase_distributed(kernels)
    train = phase_train(kernels, dev)

    # Each kernel's launches on the path that runs it, counters zeroed just
    # before that path and read just after.
    path_launches = {
        "dense_lookup": e2e["launches"], "flash_attention_fwd": e2e["launches"],
        "flash2_patch_level": untiled["auto"]["launches"],
        "dense_patch_level": forms["patch"]["launches"],
        "flash_patch_level": forms["flash"]["launches"],
        "band_patch_level": forms["band"]["launches"],
        "depthwise_residual_gelu": memflow["launches"],
        "pointwise_gemm": memflow["launches"],
        "memory_read": memflow["launches"],
    }
    rows += [depthwise, pointwise, memread]
    for row in rows:
        row["launches"] = path_launches[row["name"]].get(row["name"], 0)
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} was launched on no path")
        if "at_untiled_window" in row:
            row["at_untiled_window"]["launches"] = untiled["auto"]["launches"][row["name"]]
        if "at_memflow_frame" in row:
            row["at_memflow_frame"]["launches"] = memflow["launches"][row["name"]]
        row["spatial_launches"] = {cell: spatial[cell]["launches"][row["name"]]
                                   for cell in ("untiled_1080p", "untiled_640x480")}
        row["checked_build_launches"] = checked["launches"][row["name"]]
    log(json.dumps({"end_to_end": {k: v for k, v in e2e.items() if k != "launches"},
                    "untiled": untiled, "strided": strided, "formulations": forms,
                    "window_batch": batching, "uhd": uhd, "single_tile": single,
                    "bof": bof, "cnn": cnn, "memflow": memflow, "checked_build": checked,
                    "parity_rel_err": parity, "pipeline": pipeline, "correction": correction,
                    "data_parallel": dp, "spatial": spatial, "checkpoint": ckpt, "distributed": distributed, "train": train}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [CHECKED_ARG]:
        sys.exit(main_checked())
    if sys.argv[1:]:
        raise SystemExit(f"usage: python3 chip_smoke.py   (no arguments; {CHECKED_ARG} is its own child)")
    sys.exit(main())
