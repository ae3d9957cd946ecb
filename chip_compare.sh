#!/usr/bin/env bash
# Times the tiled 1080p main path of two trees of the repository in turns on
# one card: chip_smoke.py's tiled phase (six synthetic 1920x1080 frames
# through FlowEngine.compute_flows_tiled_stride1, then one refinement under
# torch.profiler) on another tree and on this one, in the order other, this,
# this, other, so that drift on the card does not favour either.  Prints per
# run the frames/s, the profile's busy share and its lines for K1 and K2,
# and a line "E2E <tree> <frames/s> <wall s> <refine ms> <busy ms>".
#
#     git archive <commit> | tar -x -C archive_check/parent   # a gitignored dir
#     bash chip_compare.sh archive_check/parent               # from the repository root
set -u
other=${1:?usage: bash chip_compare.sh <directory holding another tree of the repository>}
drive='
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
log=$(mktemp)
trap 'rm -f "$log"' EXIT
status=0
for tree in other this this other; do
    dir=.; [ $tree = other ] && dir=$other
    (cd "$dir" && python3 -c "$drive" $tree) > "$log" 2>&1 || status=1
    grep -E "^card|^E2E|^end to end|^profile of|flash_fwd|dense_lookup_kernel|Error|Traceback" "$log"
done
exit $status
