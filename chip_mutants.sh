#!/usr/bin/env bash
# Shows that chip_smoke.py's checks can fail: runs some of its phases on
# copies of the repository made under a temporary directory, one unbroken
# and twenty-four deliberately broken, and prints for each copy whether
# each phase passed.
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
#   readermask tpuflow_torch/csrc/memory_read.cu: K9 lists every slot as
#              valid                      -> K9's check and the MemFlow
#                                            phase fail
#   k9rescale  memory_read.cu: the readout not rescaled when a row's maximum
#              grows                      -> K9's check fails
#   taaflow    tpuflow_torch/tools/pipeline.py: the render's TAA warps along
#              the current frame's flow instead of the previous one's
#                                         -> the pipeline phase fails
#   phaseunwrap tpuflow_torch/tools/correction.py: phase_correlate_batch
#              without its Nyquist unwrap (peaks past the fold stay
#              positive)                  -> the correction phase fails
#   nccmean    correction.py: ncc_match_batch without the template's mean
#              subtracted                 -> the correction phase fails
#   meshorder  tpuflow_torch/runtime/engine.py: the replicas' shards
#              gathered in reverse order  -> the data-parallel phase fails
#   gradavg    tpuflow_torch/runtime/sharding.py: shard_train_step averages
#              the replicas' gradients with equal weights, not by shard
#              size                       -> the train phase fails
#   halo       tpuflow_torch/core/strips.py: a strip's convolutions and
#              depthwise stages read zeros in place of the neighbouring
#              strips' rows
#                                         -> the spatial phase fails
#   k1row0     dense_lookup.cu: K1 places the queries at their grid row,
#              ignoring row0               -> K1's check and the spatial
#              phase fail
#   k2keys     flash_attention.cu: K2 reads only as many key tiles as the
#              query count needs           -> K2's check and the spatial
#              phase fail
#   stripgrid  corr.py: make_corr decides on the strip's query grid, not
#              the frame's                 -> the spatial phase fails
# The unbroken copy must pass all sixteen phases.  Needs one CUDA card and
# nvcc; the repository itself is never modified.
#
#     bash chip_mutants.sh                 # from the repository root
#     bash chip_mutants.sh taaflow k2mask  # only the copies named
set -u
root=$(pwd)
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT

runner='
import sys, torch, chip_smoke as cs
cs.phase_environment(); cs.phase_build()
copy, phases = sys.argv[1], sys.argv[2].split(",")
dev = torch.device("cuda", torch.cuda.current_device())
engine = kernels = None
if "formulations" in phases or "untiled" in phases or "dataparallel" in phases or "spatial" in phases:
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
        "memflow": lambda: cs.phase_memflow(cs.kernel_counters()),
        "pipeline": lambda: cs.phase_pipeline(cs.kernel_counters()),
        "correction": lambda: cs.phase_correction(cs.kernel_counters()),
        "dataparallel": lambda: cs.phase_data_parallel(engine, kernels),
        "spatial": lambda: cs.phase_spatial(engine, kernels),
        "train": lambda: cs.phase_train(cs.kernel_counters(), dev),
        "k1": lambda: cs.check_dense_lookup(dev), "k2": lambda: cs.check_flash_attention(dev),
        "k3": lambda: cs.check_corr_patch(dev, *k3),
        "k4": lambda: cs.check_volume_patch(dev, "flat"), "k6": lambda: cs.check_volume_patch(dev, "band"),
        "k9": lambda: cs.check_memory_read(dev)}
from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level as k3f, flash2_patch_level_plain as k3p
k3 = (k3f, k3p, "tpuflow/kernels/flashcorr2.py:246")
for name in phases:
    try:
        runs[name]()
        print("COPY", copy, name, "PASSED", flush=True)
    except AssertionError as exc:
        # On a line of its own: a failure inside the CLI leaves the line of
        # its progress bar open on stderr.
        print("\nCOPY", copy, name, "FAILED:", str(exc)[:200], flush=True)
    torch.cuda.empty_cache()
'

status=0
copies=${*:-unbroken axes level k1clamp k2mask k2rescale k3origin k3chunk k3rule k4word k4last k4level \
                k1stride tilebatch readermask k9rescale taaflow phaseunwrap nccmean meshorder gradavg halo k1row0 k2keys \
                stripgrid}
for copy in $copies; do
    rm -rf "$work/copy"
    mkdir "$work/copy"
    cp -r "$root/chip_smoke.py" "$root/tpuflow_torch" "$root/native" "$work/copy/"
    rm -rf "$work/copy/tpuflow_torch/build" "$work/copy/native/build"
    cd "$work/copy" || exit 1
    edited=
    case $copy in
        unbroken)  phases=formulations,untiled,k1,k2,k3,k4,k6,k9,checked,uhd,memflow,pipeline,correction,dataparallel,spatial,train ;;
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
        readermask) phases=k9,memflow; edited=tpuflow_torch/csrc/memory_read.cu
                   sed -i 's/if (valid\[(long long)b \* cap + s\] > 0.f) slots\[n++\]/slots[n++]/' $edited ;;
        k9rescale) phases=k9; edited=tpuflow_torch/csrc/memory_read.cu
                   sed -i 's/o\[r\]\[c\] \*= alpha;/o[r][c] *= 1.f;/' $edited ;;
        taaflow)   phases=pipeline; edited=tpuflow_torch/tools/pipeline.py
                   sed -i 's/out\["taa_frame"\] = self._advance("flow", frame_f32, self.prev_flow)/out["taa_frame"] = self._advance("flow", frame_f32, flow_t)/' $edited ;;
        phaseunwrap) phases=correction; edited=tpuflow_torch/tools/correction.py
                   sed -i 's|torch.where(px > w // 2, px - w, px).float()|px.float()|; s|torch.where(py > h // 2, py - h, py).float()|py.float()|' $edited ;;
        nccmean)   phases=correction; edited=tpuflow_torch/tools/correction.py
                   sed -i 's/^    tz = template - tmean$/    tz = template/' $edited ;;
        meshorder) phases=dataparallel; edited=tpuflow_torch/runtime/engine.py
                   sed -i 's/return np.concatenate(\[f.result() for f in fetches\])/return np.concatenate([f.result() for f in fetches[::-1]])/' $edited ;;
        gradavg)   phases=train; edited=tpuflow_torch/runtime/sharding.py
                   sed -i 's|share = w.shape\[0\] / n|share = 1 / len(self.devices)|' $edited ;;
        halo)      phases=spatial; edited=tpuflow_torch/core/strips.py
                   sed -i 's/rows = strip.fetch(x, 2, start - top, stop - s - top + k)/rows = F.pad(x, (0, 0, top, k - s - top))/; s/return strip.fetch(x, 1, lo, hi), (lo - (start - h), stop + h - hi)/return F.pad(x, (0, 0, 0, 0, start - lo, hi - stop)), (lo - (start - h), stop + h - hi)/' $edited ;;
        k1row0)    phases=k1,spatial; edited=tpuflow_torch/csrc/dense_lookup.cu
                   sed -i 's/const int y = gy + row0;/const int y = gy;/' $edited ;;
        k2keys)    phases=k2,spatial; edited=tpuflow_torch/csrc/flash_attention.cu
                   sed -i 's/const int n_tiles = (Sk + kBlockN - 1) \/ kBlockN;/const int n_tiles = (min(Sq, Sk) + kBlockN - 1) \/ kBlockN;/' $edited ;;
        stripgrid) phases=spatial; edited=tpuflow_torch/core/corr.py
                   sed -i 's/    if fmap2.shape\[1\] \* fmap2.shape\[2\] > materialize_threshold:/    if fmap1.shape[1] * fmap1.shape[2] > materialize_threshold:/' $edited ;;
    esac
    if [ -n "$edited" ] && cmp -s "$root/$edited" "$edited"; then
        echo "COPY $copy: the edit did not apply"; status=1
    fi
    python3 -c "$runner" "$copy" "$phases" 2>&1 | grep -E "^COPY|vs 'dense'|^K[12] |^flash2_patch_level|^dense_patch_level|^band_patch_level|checked\]|^4K|^memflow|^memory reader|^memory_read|^pipeline|^correction|^data parallel|^spatial|^strip probe|^train|Error|Traceback" | tee "$work/$copy.log"
    want=FAILED; [ "$copy" = unbroken ] && want=PASSED
    n=$(echo "$phases" | tr ',' '\n' | wc -l)
    [ "$(grep -c "^COPY $copy .* $want" "$work/$copy.log")" = "$n" ] || status=1
    cd "$root" || exit 1
done
[ $status = 0 ] && echo "chip_mutants: ok" || echo "chip_mutants: NOT as expected"
exit $status
