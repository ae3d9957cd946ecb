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
   window's [3, 32400, 128]; the correlation-patch kernel (K3 and K5) at
   the untiled 1920x1080 window (3 x 135x240 queries, C = 256) on
   independent, smooth, small and mixed flow fields, with the share of
   query tiles that take its tensor-core path, K5 also at level 0 of the
   tile shape, both against an f32 reference; the
   volume-patch kernel (K4 flat layout, K6 band layout) bit for bit through
   its one-level and its all-levels entry, at radius 0, 1, 4 and 14 with
   patches across every plane edge, at the tile shape (timed on the device
   and on the host clock), and on a 4.5 GB level read beyond element 2^31;
   each also on ragged shapes.
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
   holds), the flows held to each other; then the pair-cached loop
   (TPUFLOW_STRIDE1=pairs) on the same clip against the trio loop.
9. 4K: one 3840x2160 frame through compute_flow_tiled with tile_batch 4 (six
   1080x1280 tiles in chunks of 4 and 2) and 6, held to each other.
10. single tile: a 640x480 clip through compute_flow_tiled and
   compute_flows_tiled_stride1 equals compute_flow bit for bit.
11. BOF (architecture 'bof', T=3): tiled stride-1 on six 1920x1080 frames and
   one untiled window (K3), then every entry point on a small clip; the cnn
   encoder (encoder 'cnn'): tiled stride-1 on four 1920x1080 frames, its
   encoders' time per frame against Twins's and their profile, then every
   entry point on a small clip.
12. parity: one small clip through the same engine weights in f32 with TF32
   off, on the CPU (plain versions) and on the card (kernels): tiled, and
   one untiled window above the materialization threshold (FlashCorr2).
13. checked build, in a child process started before phase 2 (this script
   with --checked-build, run only by the script itself): every kernel built
   with its bounds guards (kernels/_build.py, checked=True), each of the six
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


def random_volumes(g, dev, n, h, w, levels, dtype):
    vols, lh, lw = [], h, w
    for _ in range(levels):
        vols.append(torch.randn((n, lh, lw), generator=g, device=dev).to(dtype))
        lh, lw = lh // 2, lw // 2
    return vols


def window_edges(flow, r: int, dims, offset: int) -> list:
    """For each level (lh, lw) of `dims` sampled at 2^(l + offset): whether
    some query's (2r+2)^2 patch straddles the plane's left, right, top and
    bottom edge."""
    b, h, w, _ = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device, dtype=torch.float32),
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
        "library_ms": library_ms,
    }


def check_flash_attention(dev) -> dict:
    """K2 on ragged shapes, then at both shapes its paths give it, q, k, v
    bf16 with q pre-scaled by 128^-0.5 as Attention emits it: the tiled
    window's [6, 16200, 128] (127 query tiles and 127 key tiles of 128, the
    last of 72 rows) and the untiled window's [3, 32400, 128] (254 of each,
    the last of 16)."""
    qkv = qkv_draws(dev)
    check_flash_attention_ragged(qkv)

    tiled = flash_attention_at(qkv, TILE_QUERIES[0], TILE_QUERIES[1] * TILE_QUERIES[2])
    untiled = flash_attention_at(qkv, UNTILED_QUERIES[0], UNTILED_QUERIES[1] * UNTILED_QUERIES[2])
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "tpuflow_torch/csrc/flash_attention.cu",
        "replaces": "tpuflow/core/gma.py:35",
        **tiled, "at_untiled_window": untiled,
    }


def qkv_draws(dev):
    """qkv(b, s, dtype): seeded q, k, v [b, s, 128], q pre-scaled by 128^-0.5."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def qkv(b, s, dtype):
        d = 128
        q = (torch.randn((b, s, d), generator=g, device=dev) * d**-0.5).to(dtype)
        return q, *(torch.randn((b, s, d), generator=g, device=dev).to(dtype) for _ in range(2))

    return qkv


def check_flash_attention_ragged(qkv) -> None:
    """K2 on ragged shapes: the f32 FMA kernel on ragged key counts, within
    1e-4 + 1e-4|ref| (exact exponentials, f32 sums in another order); the
    bf16 kernel at B = 3 on partial query and key tiles of its 128-row CTA, S
    below one tile and tiles that end at a batch row's edge (the 3-D tensor
    map zero-fills past S instead of reading the next row)."""
    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain

    for b, s in ((1, 130), (3, 37)):
        q, k, v = qkv(b, s, torch.float32)
        got, ref = flash_attention_fwd(q, k, v), flash_attention_plain(q, k, v)
        excess = ((got - ref).abs() - 1e-4 * (1 + ref.abs())).max().item()
        log(f"K2 ragged [{b},{s},128] f32: max |kernel - plain| = {(got - ref).abs().max().item():.3e}")
        if not excess <= 0:
            raise AssertionError(f"K2 (f32) disagrees with its plain version at S={s}")
    for s in K2_RAGGED_S:
        flash_attention_draws(qkv, 3, s)


def flash_attention_draws(qkv, b: int, s: int):
    """K2 at [b, s, 128] bf16 against its plain version (chunked over
    queries) and an f32 reference, two draws.  Returns (max |kernel -
    plain|, the last draw's q, k, v)."""
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
        q, k, v = qkv(b, s, torch.bfloat16)
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
        log(f"K2 flash_attention_fwd {tuple(got.shape)} {name}: |out| rms {exact.pow(2).mean().sqrt().item():.3e}, "
            f"max |kernel - plain| = {diff.max().item():.3e} = {ratio_plain:.3e} scale, "
            f"max |kernel - f32| = {ratio_exact:.3e} scale, by norm vs f32: kernel {rel_kernel:.3e} "
            f"plain {rel_plain:.3e}")
        if not (ratio_exact <= 2**-7 and ratio_plain <= 2**-6 and rel_kernel <= 1.25 * rel_plain + 1e-4):
            raise AssertionError(f"K2 disagrees with its plain version at [{b},{s},{d}] ({name}): "
                                 f"{diff.max().item()}, by norm {rel_kernel} vs plain {rel_plain}")
    return err, q, k, v


def flash_attention_at(qkv, b: int, s: int) -> dict:
    """K2 at [b, s, 128] bf16: both draws, then its times and bound."""
    import torch.nn.functional as F

    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain

    d = 128
    err, q, k, v = flash_attention_draws(qkv, b, s)
    torch.cuda.empty_cache()
    flops = 4.0 * b * s * s * d
    nbytes = 4 * b * s * d * 2
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(lambda: flash_attention_fwd(q, k, v), reps=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), reps=5)
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=1.0),
        reps=20,
    )
    log(f"K2 [{b},{s},{d}] ms {ms:.4f}  plain {plain_ms:.4f}  sdpa {lib_ms:.4f}  bound {bound:.4f} "
        f"({flops / 1e9:.0f} GFLOP)")
    return {
        "shape": [b, s, d], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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


def check_corr_patch(dev, wrapper, plain, replaces: str, also=None) -> dict:
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
    gives it, held to the same limits."""
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
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return wall_ms, rows


def profile_refine(model, enc) -> dict:
    """Device time of one refinement by kernel name (torch.profiler), the
    share of the refinement's wall time the device was busy, and the device
    time and launches of the correlation-patch kernels (K3/K5)."""
    wall_ms, rows = device_profile(lambda: model.refine(enc))
    busy = sum(r[0] for r in rows)
    log(f"profile of one refinement ({model.decoder_depth} iterations): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f} %")
    for ms, count, key in rows[:16]:
        log(f"  {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f} % {count:5d}x  {key[:100]}")
    patch = [(ms, count) for ms, count, key in rows if "corr_patch" in key]
    patch_ms, patch_calls = sum(r[0] for r in patch), sum(r[1] for r in patch)
    if patch:
        log(f"  corr_patch kernels: {patch_ms:.2f} ms over {patch_calls} launches")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "corr_patch_ms": patch_ms,
            "corr_patch_launches": patch_calls}


def reset_launches(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def read_launches(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


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
    expected = dict.fromkeys(kernels, 0)
    expected["dense_lookup"] = windows * 2 * cfg.decoder_depth     # one launch per direction, all levels
    expected["flash_attention_fwd"] = windows * cfg.decoder_depth
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
        expected = dict.fromkeys(kernels, 0)
        expected["flash_attention_fwd"] = cfg.decoder_depth
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
    expected = dict.fromkeys(kernels, 0)
    expected["flash_attention_fwd"] = batches * cfg.decoder_depth
    expected["flash2_patch_level"] = batches * 2 * cfg.decoder_depth * cfg.corr_levels
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
                want = dict.fromkeys(kernels, 0)
                want["flash_attention_fwd"] = FORMULATION_DEPTH
                want.update(expected[name])
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
BATCH_FRAMES = 4                 # 1080p frames of the window-batch and pairs runs
UHD_H, UHD_W = 2160, 3840
SINGLE_TILE_HW = (480, 640)      # a clip that fits one tile


def expected_launches(kernels, **counts) -> dict:
    want = dict.fromkeys(kernels, 0)
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
    want = expected_launches(kernels, dense_lookup=BOF_FRAMES * 2 * cfg.decoder_depth,
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
    want = expected_launches(kernels, flash2_patch_level=2 * cfg.decoder_depth * cfg.corr_levels,
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
    want = expected_launches(kernels, dense_lookup=CNN_FRAMES * 2 * cfg.decoder_depth,
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
    same flows.  Returns the timings, the peaks and window_batch=1's flows."""
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
        want = expected_launches(kernels, dense_lookup=batches * 2 * depth, flash_attention_fwd=batches * depth)
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
    return out, frames, flows[1], out["wb1"]["wall_s"]


def phase_pairs(engine, kernels, frames, trio_flows, trio_wall: float) -> dict:
    """TPUFLOW_STRIDE1=pairs: the pair-cached loop on phase_window_batch's
    clip, one warm-up call, then timed; its flows against the trio loop's
    (window_batch=1) as two bf16 runs.  Each window's lookups run per pair:
    T-2 K1 launches per direction and iteration."""
    import os

    cfg = engine.config
    n, depth = len(frames), cfg.decoder_depth
    os.environ["TPUFLOW_STRIDE1"] = "pairs"
    try:
        engine.compute_flows_tiled_stride1(frames[:2])             # warm-up
        flows, wall, peak, launches = tiled_run(engine, kernels, frames)
    finally:
        del os.environ["TPUFLOW_STRIDE1"]
    want = expected_launches(kernels, dense_lookup=n * 2 * (cfg.sequence_length - 2) * depth,
                             flash_attention_fwd=n * depth)
    if launches != want:
        raise AssertionError(f"pairs: kernel launches {launches}, expected {want}")
    log(f"pairs loop: {n} frames in {wall:.3f} s = {n / wall:.4f} frames/s (trio {n / trio_wall:.4f} in this "
        f"call), peak {peak:.2f} GiB, launches {launches}")
    out = {"frames_per_s": n / wall, "trio_frames_per_s": n / trio_wall, "wall_s": wall, "peak_gib": peak,
           "launches": launches, "bit_equal_to_trio": bool(np.array_equal(flows, trio_flows))}
    out.update(check_flows_agree("pairs loop vs trio", flows, trio_flows))
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
        want = expected_launches(kernels, dense_lookup=chunks * 2 * depth, flash_attention_fwd=chunks * depth)
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


CHECKED_ARG = "--checked-build"


def phase_checked_start():
    """Starts this script in a child process with CHECKED_ARG (main_checked):
    the bounds-checked build of every kernel, each of the six wrappers on its
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
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    if min(launches.values()) < 1:
        raise AssertionError(f"a wrapper was not launched on the checked build: {launches}")
    log(f"checked build: {build_s:.1f} s to build, every guard held on the ragged shapes, launches {launches}")
    print(json.dumps({"build_s": build_s, "launches": launches}))
    return 0



def phase_parity() -> dict:
    """The same weights and clip in f32 (volumes too) on the CPU and on the
    card, full configuration: tiled (two 128x128 tiles per frame, dense
    pyramids, K1), and one untiled window with the materialization threshold
    lowered to 0 so that 'auto' takes the large-grid path (FlashCorr2, K3's
    f32 kernel).  Returns each path's error relative to the flow scale."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.core.corr import FlashCorr2
    from tpuflow_torch.runtime.engine import FlowEngine

    n, h, w = PARITY_SHAPE
    frames = synthetic_clip(n, h, w, SEED + 2)
    out = {"tiled": {}, "untiled": {}}
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


def kernel_counters() -> dict:
    """The six kernels' wrappers by name; each counts its launches."""
    from tpuflow_torch.kernels.bandlookup import band_patch_level
    from tpuflow_torch.kernels.denselookup import dense_lookup, dense_patch_level
    from tpuflow_torch.kernels.flashattn import flash_attention_fwd
    from tpuflow_torch.kernels.flashcorr import flash_patch_level
    from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level

    return {fn.__name__: fn for fn in (dense_lookup, flash_attention_fwd, flash2_patch_level,
                                       dense_patch_level, flash_patch_level, band_patch_level)}


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
        check_corr_patch(dev, flash2_patch_level, flash2_patch_level_plain, "tpuflow/kernels/flashcorr2.py:246"),
        check_volume_patch(dev, "flat"),
        # On the 'flash' path K5 sees level 0 of the tile shape only.
        check_corr_patch(dev, flash_patch_level, flash_patch_level_plain, "tpuflow/kernels/flashcorr.py:157",
                         also=(TILE_QUERIES, 1)),
        check_volume_patch(dev, "band"),
    ]
    far = check_volume_patch_far(dev)
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
    batching, clip, trio_flows, trio_wall = phase_window_batch(engine, kernels)
    pairs = phase_pairs(engine, kernels, clip, trio_flows, trio_wall)
    del clip, trio_flows
    torch.cuda.empty_cache()
    uhd = phase_uhd(engine, kernels)
    single = phase_single_tile(engine)
    del engine
    torch.cuda.empty_cache()
    bof = phase_bof(kernels)
    cnn = phase_cnn(kernels, e2e["stages_ms"]["features_per_frame"])
    parity = phase_parity()

    # Each kernel's launches on the path that runs it, counters zeroed just
    # before that path and read just after.
    path_launches = {
        "dense_lookup": e2e["launches"], "flash_attention_fwd": e2e["launches"],
        "flash2_patch_level": untiled["auto"]["launches"],
        "dense_patch_level": forms["patch"]["launches"],
        "flash_patch_level": forms["flash"]["launches"],
        "band_patch_level": forms["band"]["launches"],
    }
    for row in rows:
        row["launches"] = path_launches[row["name"]].get(row["name"], 0)
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} was launched on no path")
        if "at_untiled_window" in row:
            row["at_untiled_window"]["launches"] = untiled["auto"]["launches"][row["name"]]
        row["checked_build_launches"] = checked["launches"][row["name"]]
    log(json.dumps({"end_to_end": {k: v for k, v in e2e.items() if k != "launches"},
                    "untiled": untiled, "strided": strided, "formulations": forms,
                    "window_batch": batching, "pairs": pairs, "uhd": uhd, "single_tile": single,
                    "bof": bof, "cnn": cnn, "checked_build": checked, "parity_rel_err": parity}))
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
