#!/usr/bin/env bash
# Times one path of two trees of the repository in turns on one card, in the
# order other, this, this, other, so that drift on the card does not favour
# either.
#
# Tiled mode (the default): chip_smoke.py's tiled phase (six synthetic
# 1920x1080 frames through FlowEngine.compute_flows_tiled_stride1, then one
# refinement under torch.profiler).  Prints per run the frames/s, the
# profile's busy share and its lines for K1 and K2, and a line
# "E2E <tree> <frames/s> <wall s> <refine ms> <busy ms>".
#
# Untiled mode (--untiled): one untiled 1920x1080 window through
# FlowEngine.compute_flow with corr_impl='auto' (FlashCorr2, K3), as
# chip_smoke.py's untiled phase drives it: a warm-up call, a timed call,
# then the window's refinement timed alone and once under torch.profiler.
# Prints a line "UNTILED <tree> <wall s> <refine ms> <K3 device ms>
# <K3 launches> <busy ms>".
#
# Patch mode (--patch): one 'patch' (DenseCorrPyramid, K4) and one 'band'
# (BandCorrPyramid, K6) lookup at the tile shape (6 x 135x120 queries, 4
# random bf16 levels, r = 4, flows of +-40 px, seeded): the patch kernel's
# calls for the 4 levels (one call of the all-levels entry where the tree
# has one, else one call per level) and the whole lookup, each timed on the
# device (queued behind a sleep) and on the host clock (CUDA events around
# calls on an idle card), then one lookup under torch.profiler.  Prints its
# largest kernels and a line "PATCH <tree> <layout> <kernel device ms>
# <kernel host ms> <lookup device ms> <lookup host ms> <lookup busy ms>
# <patch-kernel device ms> <patch-kernel launches>".
#
# Flows mode (--flows): no timing; each tree once computes the tiled
# phase's flows (six 1920x1080 frames, compute_flows_tiled_stride1) and one
# untiled window's (compute_flow, 'auto'), and the two trees' flows are
# compared bit for bit.  Prints "FLOWS BIT-EQUAL" (exit 0) or "FLOWS DIFFER"
# (exit 1) with the result per path.
#
#     git archive <commit> | tar -x -C archive_check/parent   # a gitignored dir
#     bash chip_compare.sh archive_check/parent               # from the repository root
#     bash chip_compare.sh --untiled archive_check/parent
#     bash chip_compare.sh --patch archive_check/parent
#     bash chip_compare.sh --flows archive_check/parent
set -u
mode=tiled
if [ "${1:-}" = --untiled ]; then mode=untiled; shift; fi
if [ "${1:-}" = --patch ]; then mode=patch; shift; fi
if [ "${1:-}" = --flows ]; then mode=flows; shift; fi
other=${1:?usage: bash chip_compare.sh [--untiled | --patch | --flows] <directory holding another tree of the repository>}
drive_tiled='
import sys, chip_smoke as cs
cs.phase_environment()
from tpuflow_torch.config import ModelConfig
from tpuflow_torch.runtime.engine import FlowEngine
from tpuflow_torch.kernels.bandlookup import band_patch_level
from tpuflow_torch.kernels.denselookup import dense_lookup, dense_patch_level
from tpuflow_torch.kernels.flashattn import flash_attention_fwd
from tpuflow_torch.kernels.flashcorr import flash_patch_level
from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level
kernels = {fn.__name__: fn for fn in (dense_lookup, flash_attention_fwd, flash2_patch_level,
                                      dense_patch_level, flash_patch_level, band_patch_level)}
engine = FlowEngine(ModelConfig(), seed=cs.SEED)
engine.load_model(allow_random_init=True)
r = cs.phase_end_to_end(engine, kernels)
print("E2E", sys.argv[1], r["frames_per_s"], r["wall_s"], r["stages_ms"]["refine"],
      r["refine_profile"]["device_busy_ms"])
'
# Only what both trees share: the engine, chip_smoke.synthetic_clip and
# timed_call, and the profiler read here.
drive_untiled='
import sys, torch, chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
cs.phase_environment()
from tpuflow_torch.config import ModelConfig
from tpuflow_torch.core.corr import FlashCorr2
from tpuflow_torch.runtime.engine import FlowEngine
engine = FlowEngine(ModelConfig(), seed=cs.SEED)
engine.load_model(allow_random_init=True)
model, t = engine.model, engine.config.sequence_length
model.corr_impl = "auto"
frames = cs.synthetic_clip(t, cs.MAIN_H, cs.MAIN_W, cs.SEED + 5)
engine.compute_flow(frames, t // 2)
flow, wall = cs.timed_call(lambda: engine.compute_flow(frames, t // 2))
with torch.inference_mode():
    x = torch.from_numpy(frames[None]).to(engine.device).float() / 255.0
    enc = model.encode(x)
    assert isinstance(enc.corr_fwd, FlashCorr2), type(enc.corr_fwd).__name__
    _, t_ref = cs.timed_call(lambda: model.refine(enc))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.refine(enc)
        torch.cuda.synchronize()
busy = k3_ms = 0.0
k3_n = 0
for ev in prof.key_averages():
    us = getattr(ev, "self_device_time_total", None)
    if us is None:
        us = getattr(ev, "self_cuda_time_total", 0)
    if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
        busy += us / 1e3
        if "corr_patch" in ev.key:
            k3_ms += us / 1e3
            k3_n += ev.count
            print(f"  {us / 1e3:9.2f} ms {ev.count:5d}x  {ev.key[:100]}")
print("UNTILED", sys.argv[1], wall, t_ref * 1e3, k3_ms, k3_n, busy)
'
# Only what both trees share: chip_smoke.time_ms (with queued=), random_volumes
# and TILE_QUERIES, the correlation classes and their geometry helpers, and
# the one-level patch wrappers.
drive_patch='
import sys, torch, chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
cs.phase_environment()
from tpuflow_torch.core import corr as tc
from tpuflow_torch.kernels import bandlookup as bl, denselookup as dl
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
(b, h, w), r = cs.TILE_QUERIES, 4
flow = (torch.rand((b, h, w, 2), generator=g, device=dev) * 80.0 - 40.0).contiguous()
vols = cs.random_volumes(g, dev, b * h * w, h, w, 4, torch.bfloat16)
for layout in ("flat", "band"):
    if layout == "flat":
        corr, one, many = tc.DenseCorrPyramid(vols), dl.dense_patch_level, getattr(dl, "dense_patch_levels", None)
        dims = [(v.shape[1], v.shape[2]) for v in vols]
        lookup = lambda: corr.lookup(flow, r, impl="patch")
    else:
        corr = None
        vols = [v.reshape(b, h * w, *v.shape[1:]).transpose(1, 2).contiguous() for v in vols]
        corr, one, many = tc.BandCorrPyramid(vols), bl.band_patch_level, getattr(bl, "band_patch_levels", None)
        dims = [(v.shape[1], v.shape[3]) for v in vols]
        lookup = lambda: corr.lookup(flow, r)
    bx, by = tc._base_coords(flow)
    idx = [tc._radius_patch_indices(bx, by, l, lh, lw, r) for l, (lh, lw) in enumerate(dims)]
    rrs, ccs = [i.rr for i in idx], [i.cc for i in idx]
    if many is not None:
        kernel = lambda: many(vols, rrs, ccs)
    else:
        kernel = lambda: [one(v, rr, cc) for v, rr, cc in zip(vols, rrs, ccs)]
    with torch.inference_mode():
        times = [cs.time_ms(fn, reps=20, queued=q) for fn in (kernel, lookup) for q in (True, False)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lookup()
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    for ms, n, key in rows[:8]:
        print(f"  {layout} {ms:8.4f} ms {n:4d}x  {key[:90]}")
    patch = [(ms, n) for ms, n, key in rows if "volume_patch" in key]
    print("PATCH", sys.argv[1], layout, *times, sum(x[0] for x in rows), sum(x[0] for x in patch),
          sum(x[1] for x in patch))
'
# Only what both trees share: the engine and chip_smoke.synthetic_clip.
drive_flows='
import sys, numpy as np, chip_smoke as cs
cs.phase_environment()
from tpuflow_torch.config import ModelConfig
from tpuflow_torch.runtime.engine import FlowEngine
engine = FlowEngine(ModelConfig(), seed=cs.SEED)
engine.load_model(allow_random_init=True)
frames = cs.synthetic_clip(cs.MAIN_FRAMES, cs.MAIN_H, cs.MAIN_W, cs.SEED)
tiled, untiled = engine.compute_flows_tiled_stride1(frames), engine.compute_flow(frames, 2)
np.savez(sys.argv[2], tiled=tiled, untiled=untiled)
print("FLOWS", sys.argv[1], "mean |flow| tiled", float(np.abs(tiled).mean()), "untiled", float(np.abs(untiled).mean()))
'
drive=$drive_tiled; pattern="^card|^E2E|^end to end|^profile of|flash_fwd|dense_lookup_kernel|Error|Traceback"
if [ $mode = untiled ]; then
    drive=$drive_untiled; pattern="^card|^UNTILED|corr_patch|Error|Traceback"
fi
if [ $mode = patch ]; then
    drive=$drive_patch; pattern="^card|^PATCH|^  (flat|band) |Error|Traceback"
fi
log=$(mktemp)
trap 'rm -f "$log"' EXIT
status=0
if [ $mode = flows ]; then
    work=$(mktemp -d)
    trap 'rm -f "$log"; rm -rf "$work"' EXIT
    for tree in other this; do
        dir=.; [ $tree = other ] && dir=$other
        (cd "$dir" && python3 -c "$drive_flows" $tree "$work/$tree.npz") > "$log" 2>&1 || status=1
        grep -E "^card|^FLOWS|Error|Traceback" "$log"
    done
    python3 -c '
import sys, numpy as np
a, b = np.load(sys.argv[1]), np.load(sys.argv[2])
same = {k: bool(np.array_equal(a[k], b[k])) for k in a.files}
print("FLOWS BIT-EQUAL" if all(same.values()) else "FLOWS DIFFER", same)
sys.exit(0 if all(same.values()) else 1)' "$work/other.npz" "$work/this.npz" || status=1
    exit $status
fi
for tree in other this this other; do
    dir=.; [ $tree = other ] && dir=$other
    (cd "$dir" && python3 -c "$drive" $tree) > "$log" 2>&1 || status=1
    grep -E "$pattern" "$log"
done
exit $status
