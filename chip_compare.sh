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
#     git archive <commit> | tar -x -C archive_check/parent   # a gitignored dir
#     bash chip_compare.sh archive_check/parent               # from the repository root
#     bash chip_compare.sh --untiled archive_check/parent
set -u
mode=tiled
if [ "${1:-}" = --untiled ]; then mode=untiled; shift; fi
other=${1:?usage: bash chip_compare.sh [--untiled] <directory holding another tree of the repository>}
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
drive=$drive_tiled; pattern="^card|^E2E|^end to end|^profile of|flash_fwd|dense_lookup_kernel|Error|Traceback"
if [ $mode = untiled ]; then
    drive=$drive_untiled; pattern="^card|^UNTILED|corr_patch|Error|Traceback"
fi
log=$(mktemp)
trap 'rm -f "$log"' EXIT
status=0
for tree in other this this other; do
    dir=.; [ $tree = other ] && dir=$other
    (cd "$dir" && python3 -c "$drive" $tree) > "$log" 2>&1 || status=1
    grep -E "$pattern" "$log"
done
exit $status
