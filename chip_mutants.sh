#!/usr/bin/env bash
# Shows that chip_smoke.py's checks can fail: runs some of its phases on
# copies of the repository made under a temporary directory, one unbroken
# and thirteen deliberately broken, and prints for each copy whether each
# phase passed.
#   axes       tpuflow_torch/core/corr.py: the lookup window's x and y axes
#              left unswapped              -> formulations and untiled fail
#   level      corr.py: the deepest pyramid level sampled at level 2's
#              scale                       -> formulations and untiled fail
#   k1clamp    csrc/dense_lookup.cu: taps outside the plane read from the
#              clamped address instead of 0 -> K1's kernel check fails
#   k2mask     csrc/flash_attention.cu: the last key tile's mask removed, so
#              zero-filled keys past S score 0 -> K2's kernel check fails
#   k2rescale  flash_attention.cu: the accumulator not rescaled when the row
#              max moves                   -> K2's kernel check fails
#   k3origin   csrc/corr_patch.cu: the tensor path's column offsets taken
#              from a box origin one column off -> K3's kernel check fails
#   k3chunk    corr_patch.cu: the tensor path's last 16-channel k-step
#              skipped                     -> K3's kernel check fails
#   k3rule     corr_patch.cu: boxes of up to 4x the cap sent to the tensor
#              path, whose S holds only the cap -> K3's kernel check fails
#   k4word     csrc/volume_patch.cu: the word loads of each patch row one
#              word off                   -> K4's and K6's checks fail
#   k4last     volume_patch.cu: the last query of every run not stored
#                                         -> K4's and K6's checks fail
#   k4level    volume_patch.cu: the all-levels entry handing level l the
#              row indices of level l - 1 -> K4's and K6's checks fail
#   k1stride   csrc/dense_lookup.cu: level l's query planes strided by level
#              l - 1's plane size, a read past the level's end that stays
#              in memory the process owns -> the checked build traps (and
#              K1's tolerance check fails too)
#   tilebatch  tpuflow_torch/runtime/engine.py: compute_flow_tiled drops the
#              last chunk of tile_batch tiles -> the 4K phase fails
# The unbroken copy must pass all nine phases.  Needs one CUDA card and
# nvcc; the repository itself is never modified.
#
#     bash chip_mutants.sh        # from the repository root
set -u
root=$(pwd)
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT

runner='
import sys, torch, chip_smoke as cs
cs.phase_environment(); cs.phase_build()
copy, phases = sys.argv[1], sys.argv[2].split(",")
dev = torch.device("cuda")
engine = kernels = None
if "formulations" in phases or "untiled" in phases:
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
if "uhd" in phases and engine is None:
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine
    kernels = cs.kernel_counters()
    engine = FlowEngine(ModelConfig(), seed=cs.SEED)
    engine.load_model(allow_random_init=True)
runs = {"formulations": lambda: cs.phase_formulations(engine, kernels),
        "untiled": lambda: cs.phase_untiled(engine, kernels),
        "checked": lambda: cs.phase_checked_wait(cs.phase_checked_start()),
        "uhd": lambda: cs.phase_uhd(engine, kernels),
        "k1": lambda: cs.check_dense_lookup(dev), "k2": lambda: cs.check_flash_attention(dev),
        "k3": lambda: cs.check_corr_patch(dev, *k3),
        "k4": lambda: cs.check_volume_patch(dev, "flat"), "k6": lambda: cs.check_volume_patch(dev, "band")}
from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level as k3f, flash2_patch_level_plain as k3p
k3 = (k3f, k3p, "tpuflow/kernels/flashcorr2.py:246")
for name in phases:
    try:
        runs[name]()
        print("COPY", copy, name, "PASSED")
    except AssertionError as exc:
        print("COPY", copy, name, "FAILED:", str(exc)[:200])
    torch.cuda.empty_cache()
'

status=0
for copy in unbroken axes level k1clamp k2mask k2rescale k3origin k3chunk k3rule k4word k4last k4level \
            k1stride tilebatch; do
    rm -rf "$work/copy"
    mkdir "$work/copy"
    cp -r "$root/chip_smoke.py" "$root/tpuflow_torch" "$work/copy/"
    rm -rf "$work/copy/tpuflow_torch/build"
    cd "$work/copy" || exit 1
    edited=
    case $copy in
        unbroken)  phases=formulations,untiled,k1,k2,k3,k4,k6,checked,uhd ;;
        axes)      phases=formulations,untiled; edited=tpuflow_torch/core/corr.py
                   sed -i 's/^    sampled = sampled.transpose(2, 3) .*$/    pass/' $edited ;;
        level)     phases=formulations,untiled; edited=tpuflow_torch/core/corr.py
                   sed -i 's/_radius_patch_indices(base_x, base_y, lvl0 + level_offset, lh, lw, radius)/_radius_patch_indices(base_x, base_y, min(lvl0 + level_offset, 2), lh, lw, radius)/' $edited ;;
        k1clamp)   phases=k1; edited=tpuflow_torch/csrc/dense_lookup.cu
                   sed -i 's/inside ? to_f32(__ldg(pl + gr \* lw + gc)) : 0.0f/to_f32(__ldg(pl + min(max(gr, 0), lh - 1) * lw + min(max(gc, 0), lw - 1)))/' $edited ;;
        k2mask)    phases=k2; edited=tpuflow_torch/csrc/flash_attention.cu
                   sed -i '/sacc\[i\] = -CUDART_INF_F;/d' $edited ;;
        k2rescale) phases=k2; edited=tpuflow_torch/csrc/flash_attention.cu
                   sed -i '/oacc\[i\] \*= (i & 2) ? a1 : a0;/d' $edited ;;
        k3origin)  phases=k3; edited=tpuflow_torch/csrc/corr_patch.cu
                   sed -i 's/(short)(s_cc\[m \* kMaxSide + lane - side\] - c0);/(short)(s_cc[m * kMaxSide + lane - side] - c0 + 1);/' $edited ;;
        k3chunk)   phases=k3; edited=tpuflow_torch/csrc/corr_patch.cu
                   sed -i 's/    for (; k + 16 < C; k += 32) {/    for (; k + 48 < C; k += 32) {/' $edited ;;
        k3rule)    phases=k3; edited=tpuflow_torch/csrc/corr_patch.cu
                   sed -i 's/const bool tensor = npix <= kMaxBox;/const bool tensor = npix <= 4 * kMaxBox;/' $edited ;;
        k4word)    phases=k4,k6; edited=tpuflow_torch/csrc/volume_patch.cu
                   sed -i 's/const uint32_t\* word = reinterpret_cast<const uint32_t\*>(s_addr\[t\]) + g;/const uint32_t* word = reinterpret_cast<const uint32_t*>(s_addr[t]) + g + 1;/' $edited ;;
        k4last)    phases=k4,k6; edited=tpuflow_torch/csrc/volume_patch.cu
                   sed -i 's/const int nwords = nrows \* words;/const int nwords = (nrows - side) * words;/' $edited ;;
        k4level)   phases=k4,k6; edited=tpuflow_torch/csrc/volume_patch.cu
                   sed -i 's/lv.rr\[l\] = rrs\[l\];/lv.rr[l] = rrs[l > 0 ? l - 1 : 0];/' $edited ;;
        k1stride)  phases=checked,k1; edited=tpuflow_torch/csrc/dense_lookup.cu
                   sed -i 's/static_cast<const T\*>(levels.vol\[l\]) + (int64_t)q \* ((int64_t)lh \* lw);/static_cast<const T*>(levels.vol[l]) + (int64_t)q * ((int64_t)levels.lh[l > 0 ? l - 1 : 0] * levels.lw[l > 0 ? l - 1 : 0]);/' $edited ;;
        tilebatch) phases=uhd; edited=tpuflow_torch/runtime/engine.py
                   sed -i 's/for c0 in range(0, len(idxs), tile_batch):/for c0 in range(0, len(idxs) - tile_batch + 1, tile_batch):/' $edited ;;
    esac
    if [ -n "$edited" ] && cmp -s "$root/$edited" "$edited"; then
        echo "COPY $copy: the edit did not apply"; status=1
    fi
    python3 -c "$runner" "$copy" "$phases" 2>&1 | grep -E "^COPY|vs 'dense'|^K[12] |^flash2_patch_level|^dense_patch_level|^band_patch_level|checked\]|^4K|Error|Traceback" | tee "$work/$copy.log"
    want=FAILED; [ "$copy" = unbroken ] && want=PASSED
    n=$(echo "$phases" | tr ',' '\n' | wc -l)
    [ "$(grep -c "^COPY $copy .* $want" "$work/$copy.log")" = "$n" ] || status=1
    cd "$root" || exit 1
done
[ $status = 0 ] && echo "chip_mutants: ok" || echo "chip_mutants: NOT as expected"
exit $status
