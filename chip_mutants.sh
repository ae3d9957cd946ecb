#!/usr/bin/env bash
# Shows that chip_smoke.py's comparisons between correlation formulations can
# fail: runs its formulation and untiled phases on copies of the repository
# made under a temporary directory, one unbroken and two deliberately broken
# in tpuflow_torch/core/corr.py (the lookup window's x and y axes left
# unswapped; the deepest pyramid level sampled at level 2's scale), and prints
# for each copy whether each phase passed.  The unbroken copy must pass both
# phases and each broken copy must fail both.  Needs one CUDA card and nvcc;
# the repository itself is never modified.
#
#     bash chip_mutants.sh        # from the repository root
set -u
root=$(pwd)
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT

runner='
import sys, torch, chip_smoke as cs
cs.phase_environment(); cs.phase_build()
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
for name, phase in (("formulations", cs.phase_formulations), ("untiled", cs.phase_untiled)):
    try:
        phase(engine, kernels)
        print("COPY", sys.argv[1], name, "PASSED")
    except AssertionError as exc:
        print("COPY", sys.argv[1], name, "FAILED:", str(exc)[:200])
    torch.cuda.empty_cache()
'

status=0
for copy in unbroken axes level; do
    rm -rf "$work/copy"
    mkdir "$work/copy"
    cp -r "$root/chip_smoke.py" "$root/tpuflow_torch" "$work/copy/"
    rm -rf "$work/copy/tpuflow_torch/build"
    cd "$work/copy" || exit 1
    case $copy in
        axes)  sed -i 's/^    sampled = sampled.transpose(2, 3) .*$/    pass/' tpuflow_torch/core/corr.py ;;
        level) sed -i 's/_radius_patch_indices(base_x, base_y, lvl0 + level_offset, lh, lw, radius)/_radius_patch_indices(base_x, base_y, min(lvl0 + level_offset, 2), lh, lw, radius)/' tpuflow_torch/core/corr.py ;;
    esac
    if [ "$copy" != unbroken ] && cmp -s "$root/tpuflow_torch/core/corr.py" tpuflow_torch/core/corr.py; then
        echo "COPY $copy: the edit did not apply"; status=1
    fi
    python3 -c "$runner" "$copy" 2>&1 | grep -E "^COPY|vs 'dense'|Error|Traceback" | tee "$work/$copy.log"
    want=FAILED; [ "$copy" = unbroken ] && want=PASSED
    [ "$(grep -c "^COPY $copy .* $want" "$work/$copy.log")" = 2 ] || status=1
    cd "$root" || exit 1
done
[ $status = 0 ] && echo "chip_mutants: ok" || echo "chip_mutants: NOT as expected"
exit $status
