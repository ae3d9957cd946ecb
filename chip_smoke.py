#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpuflow_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result lines):

1. environment: a CUDA device is required; prints nvidia-smi's name and
   power limit.
2. build: every CUDA kernel from tpuflow_torch/csrc, one nvcc per source,
   all started together.
3. kernels: each kernel against its plain PyTorch version at the shapes of
   the main path (1920x1080 frame, two 960x1080 tiles, /8 grid 135x120,
   6 batch rows per window), with its time, its plain version's time, its
   bound on the card and, where one exists, one PyTorch call's time.
4. end to end: FlowEngine.compute_flows_tiled_stride1 on six synthetic
   1920x1080 frames at the full configuration (Twins-SVT, 4 levels, radius
   4, 12 iterations, T=5, bf16, seeded random weights).  The kernels'
   launch counters are zeroed just before and read just after.
5. parity: one small clip through the same engine weights in f32 with TF32
   off, on the CPU (plain versions) and on the card (kernels).

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
PARITY_SHAPE = (5, 128, 256)      # frames, H, W: two 128x128 tiles at tile_size 128
SEED = 0


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def phase_build() -> None:
    from tpuflow_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def random_volumes(g, dev, n, h, w, levels, dtype):
    vols, lh, lw = [], h, w
    for _ in range(levels):
        vols.append(torch.randn((n, lh, lw), generator=g, device=dev).to(dtype))
        lh, lw = lh // 2, lw // 2
    return vols


def check_dense_lookup(dev) -> dict:
    """K1 on ragged shapes (198 queries: no power-of-two block divides it;
    flows of 1.5x the grid push whole windows off the plane), then at the
    main path: 4 levels of bf16 volumes for 6 x 135 x 120 queries, radius
    4, flows of +-40 px."""
    from tpuflow_torch.kernels.denselookup import dense_lookup, dense_lookup_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    for levels, r, dtype in ((3, 2, torch.float32), (4, 4, torch.bfloat16)):
        b, h, w = 2, 9, 11
        vols = random_volumes(g, dev, b * h * w, h, w, levels, dtype)
        flow = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * torch.tensor(
            [1.5 * w, 1.5 * h], device=dev)
        err = (dense_lookup(vols, flow, r) - dense_lookup_plain(vols, flow, r)).abs().max().item()
        log(f"K1 ragged {b}x{h}x{w} L={levels} r={r} {dtype}: max |kernel - plain| = {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"K1 disagrees with its plain version on a ragged shape: {err}")

    b, h, w, levels, r = 6, 135, 120, 4, 4
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
    """K2 at the main path: q, k, v [6, 16200, 128] bf16, q pre-scaled by
    128^-0.5 as Attention emits it."""
    import torch.nn.functional as F

    from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def qkv(b, s, dtype):
        d = 128
        q = (torch.randn((b, s, d), generator=g, device=dev) * d**-0.5).to(dtype)
        return q, *(torch.randn((b, s, d), generator=g, device=dev).to(dtype) for _ in range(2))

    # Ragged key counts (a partial last tile, S below one tile) in both
    # dtypes: bf16 within 1e-2 + 1e-2|ref| (see below), f32 (the FMA
    # kernel, exact exponentials) within 1e-4 + 1e-4|ref|.
    for b, s, dtype, tol in ((2, 99, torch.bfloat16, 1e-2), (1, 130, torch.float32, 1e-4),
                             (3, 37, torch.float32, 1e-4)):
        q, k, v = qkv(b, s, dtype)
        got, ref = flash_attention_fwd(q, k, v).float(), flash_attention_plain(q, k, v).float()
        excess = ((got - ref).abs() - tol * (1 + ref.abs())).max().item()
        log(f"K2 ragged [{b},{s},128] {dtype}: max |kernel - plain| = {(got - ref).abs().max().item():.3e}")
        if not excess <= 0:
            raise AssertionError(f"K2 disagrees with its plain version at S={s} {dtype}")

    # Main path, two draws.  At the model's scale (logits N(0, 1) over 16200
    # keys) the softmax is nearly uniform and outputs are ~0.01; with a
    # logit spread of 4 (q scaled up) a few keys dominate and outputs are
    # O(0.3).  Each draw is held to an f32 reference `exact`:
    # - elementwise, against the rounding bound.  Both the kernel and the
    #   plain version round each probability (relative 2^-8, bf16's unit
    #   roundoff) and the output (2^-8 |out|) to bf16, so each errs by at
    #   most 2^-7 * scale with scale = softmax(q k^T) |v|, and the two differ
    #   by at most 2^-6 * scale;
    # - by norm: the kernel no worse than the plain bf16 version by more
    #   than a quarter.  A dropped or doubled 64-key tile moves the output by
    #   about sqrt(64 / 16200) = 6e-2 of its norm even at the model's scale.
    b, s, d = 6, 135 * 120, 128
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
            raise AssertionError(f"K2 disagrees with its plain version ({name}): {diff.max().item()}, "
                                 f"by norm {rel_kernel} vs plain {rel_plain}")
    del exact, scale, got, ref

    flops = 4.0 * b * s * s * d
    nbytes = 4 * b * s * d * 2
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(lambda: flash_attention_fwd(q, k, v), reps=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), reps=5)
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=1.0),
        reps=20,
    )
    log(f"K2 ms {ms:.4f}  plain {plain_ms:.4f}  sdpa {lib_ms:.4f}  bound {bound:.4f} ({flops / 1e9:.0f} GFLOP)")
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "tpuflow_torch/csrc/flash_attention.cu",
        "replaces": "tpuflow/core/gma.py:35",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": lib_ms,
    }


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


def profile_refine(model, enc) -> dict:
    """Device time of one refinement by kernel name (torch.profiler), and
    the share of the refinement's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.refine(enc)
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
    busy = sum(r[0] for r in rows)
    log(f"profile of one refinement ({model.decoder_depth} iterations): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f} %")
    for ms, count, key in rows[:16]:
        log(f"  {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f} % {count:5d}x  {key[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy}


def phase_end_to_end(kernels) -> dict:
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine

    cfg = ModelConfig()
    engine = FlowEngine(cfg, seed=SEED)          # device defaults to the card
    log("weights:", engine.load_model(allow_random_init=True), "dtype", engine.model.dtype)
    frames = synthetic_clip(MAIN_FRAMES, MAIN_H, MAIN_W, SEED)

    stage_times(engine, frames)                  # warms cuDNN and the kernels

    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flows = engine.compute_flows_tiled_stride1(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    if flows.shape != (MAIN_FRAMES, MAIN_H, MAIN_W, 2) or not np.isfinite(flows).all():
        raise AssertionError(f"bad flows: shape {flows.shape}, finite {np.isfinite(flows).all()}")
    windows = MAIN_FRAMES                        # one window (both tiles batched) per frame
    expected = {
        "dense_lookup": windows * 2 * cfg.decoder_depth,       # one launch per direction, all levels
        "flash_attention_fwd": windows * cfg.decoder_depth,
    }
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


def phase_parity() -> float:
    """The same weights and clip in f32 (volumes too) on the CPU and on the
    card, full configuration, two 128x128 tiles per frame."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine

    n, h, w = PARITY_SHAPE
    frames = synthetic_clip(n, h, w, SEED + 2)
    out = {}
    for dev in ("cpu", "cuda"):
        engine = FlowEngine(ModelConfig(), seed=SEED + 2, device=dev, dtype=torch.float32)
        engine.model.corr_dtype = torch.float32
        engine.load_model(allow_random_init=True)
        out[dev] = engine.compute_flows_tiled_stride1(frames, tile_size=128)
    scale = max(1.0, float(np.abs(out["cpu"]).max()))
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    log(f"parity f32 card vs cpu on {n}x{h}x{w}: max |diff| = {err:.3e}, flow scale {scale:.3f}, "
        f"relative {err / scale:.3e}")
    # f32 with TF32 off on both: convolution and matmul sums in another
    # order, fed back through 12 iterations.
    if not np.isfinite(out["cuda"]).all() or err / scale > 2e-3:
        raise AssertionError(f"card and CPU disagree: {err} at flow scale {scale}")
    return err / scale


def main() -> int:
    smi = phase_environment()
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        from tpuflow_torch.kernels.denselookup import dense_lookup
        from tpuflow_torch.kernels.flashattn import flash_attention_fwd
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: run from the repository root ({exc})")
    kernels = {"dense_lookup": dense_lookup, "flash_attention_fwd": flash_attention_fwd}

    phase_build()
    rows = [check_dense_lookup(dev), check_flash_attention(dev)]
    torch.cuda.empty_cache()
    e2e = phase_end_to_end(kernels)
    torch.cuda.empty_cache()
    parity = phase_parity()

    for row in rows:
        row["launches"] = e2e["launches"][row["name"]]
    log(json.dumps({"end_to_end": {k: v for k, v in e2e.items() if k != "launches"},
                    "parity_rel_err": parity}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
