"""The untiled MOF cell, mof-untiled-1080p: its readers follow their lists,
its route's counts at 1080p are pinned, its route's reference flow agrees
with the program's compute_flow_batch on both correlation formulations, and
its runs on the CPU at a small size (128 x 128 frames, two refinement
iterations, one clip of five frames) are correct untraced and traced, while
faults_mof.py's plants are caught.

The cell's limit is set at 1080p on the card in bfloat16; here the program
runs in float32 (it reads 4.6e-4 px of a mean flow, 2.4e-3 at a pixel, no
outlier) and is held to limits of this size, SMALL_LIMITS.  The plants read
0.112 px (the fp8 control), 0.157 px (zero start) and 22.6 px at a pixel
with 1.56 % of the pixels outliers (a flow moved by 16 px over 16 x 16 of
128 x 128), each several times over them.  The flows here are a few pixels
long, under the outlier share's 3 px, so the end-point gaps are held too."""

import numpy as np
import pytest

from flowbench import counts, faults_mof, harness, spec as spec_mod, trace as trace_mod, traffic
from flowbench.counts import patch_lookup
from flowbench.models import program_engine
from flowbench.reference import plain
from flowbench.tests import small

CELL = "mof-untiled-1080p"
SEED = 2**31 + 419
SMALL_LIMITS = {"flow_epe_px": 0.02, "flow_epe_max_px": 0.1, "flow_outlier_pct": 0.5}
SMALL = {**small.DEPTH,
         "traffic": {**small.TRAFFIC, "width": 128, "segment_frames": 5, "segments": 1},
         "cell": {"check_frames": 1, "limits": SMALL_LIMITS}}
# The CPU runs no K2 or K3 kernel: the traced run is given one of each.
K2_US, K3_US = 2000.0, 3000.0
READERS = {"step_mfu_pct", "sk_update_ms_per_frame", "k2_roofline", "k3_ms_per_frame", "k3_roofline",
           "device_idle_pct.engine", "upload_idle_ms_per_frame", "mof_encode_ms_per_frame",
           "mof_refine_ms_per_frame", "mof_corr_ms_per_frame"}
# Shares of the reference's mean flow, as test_flowbench_reference.py holds
# MemFlow: float32 on both sides, the lookups' arithmetic apart by ~1e-5 of
# a correlation value.
MEAN_TOL, MAX_TOL = 3e-3, 2e-2


def run(traced=False, patch=None, keep=None):
    return harness.run_cell(CELL, SEED, 0.001, traced, "cpu", overrides=SMALL, patch=patch, keep=keep)


def route_of(overrides=None, seed=SEED):
    spec = spec_mod.Spec()
    r = harness.Run(CELL, seed, 1, False, "cpu", 0.0, spec, overrides)
    return spec.route_module(r.cell["route"]).Route(r)


def test_the_cells_readers_follow_their_lists():
    spec = spec_mod.Spec()
    assert {m["name"] for m in spec.per_layer(CELL)} == READERS
    assert {m["name"] for m in spec.end_to_end(CELL)} == {"frames_per_s", "peak_mem_gib", "setup_s"}
    for name in READERS:
        mod = spec.metric_module(name)
        assert callable(mod.read) and mod.MOVES == "frames_per_s", name
    cell = spec.cells()[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("videoflow-mof-twins-untiled", "video-1080p-seg24", 1)
    assert spec.workload(CELL)["route"] == "mof_untiled"


def test_the_untiled_configuration_is_the_tiled_model():
    """The untiled cell's configuration is the tiled cell's model, run as
    the CLI runs it without --tile: only the deployment it states differs."""
    spec = spec_mod.Spec()
    untiled, tiled = spec.config("videoflow-mof-twins-untiled"), spec.config("videoflow-mof-twins")
    assert untiled.pop("deployment") != tiled.pop("deployment")
    assert untiled == tiled


def test_the_routes_counts_at_1080p():
    route = route_of()
    assert route.aggregation() == (3, 32400, 128, 12)
    # The same S^2 work a frame as the tiled cell's 6 rows of 16 200 tokens,
    # twice over: 3 x 32 400^2 against 6 x 16 200^2.
    assert counts.k2_per_frame(route) == (2 * 9_674_588_160_000, 1_194_393_600)
    # 12 iterations x 2 directions, 3 interior frames x 135 x 240 queries.
    assert route.patch_lookups() == (24, 97_200, 4, 4, 256)
    # Both encoders on one whole frame, and a window's attention, pyramids,
    # refinement and upsample over whole frames: 7.05e12 above the tiled
    # cell's count, from the pyramids and GMA over 32 400 tokens in place
    # of 16 200 and Twins' global attention over whole frames.
    assert counts.model_flops_per_frame(route) == 30_146_484_356_096


@pytest.mark.parametrize("threshold", [None, 0], ids=["dense", "flashcorr2"])
def test_reference_flow_matches_compute_flow_batch(threshold):
    # 64 x 96 frames: Twins' strided key convs (sr 8 on the 1/4 grid, 4 on
    # the 1/8 one) divide both grids, where the program's 'SAME' padding and
    # the reference's timm padding of 0 give the same keys (ROADMAP.md's
    # findings: "GSA pads 'SAME' where timm pads 0"; at 72 x 88 the two
    # encoders part by up to a third of their largest feature).
    over = {"model_config": {"decoder_depth": 2, "corr_levels": 2, "corr_radius": 2},
            "reference_args": {"decoder_depth": 2, "corr_levels": 2, "corr_radius": 2},
            "traffic": {**small.TRAFFIC, "width": 96, "height": 64, "segment_frames": 5, "segments": 1}}
    route = route_of(over, 2**31 + 7)
    run = route.run
    sd, ref_state = run.draw_weights()
    engine = program_engine(run.config, sd, "cpu")
    if threshold is not None:
        # Above the grid's 8 x 12 cells: the 'auto' correlation recomputes
        # patches with FlashCorr2, K3's path at 1080p.
        engine.model.materialize_threshold = threshold
    seg = traffic.segment(run.traffic, run.seed, 0, "cpu")
    model = run.reference(ref_state)
    for i in (0, 2, 4):
        got = engine.compute_flow_batch(seg, [i])[0]
        mean, mx, scale = plain.flow_gaps(got, route.reference_flow(model, seg, i))
        assert scale > 0.1 and mean < MEAN_TOL * scale and mx < MAX_TOL * scale, (i, mean, mx, scale)


def test_untraced_and_traced_runs_are_correct(monkeypatch):
    traced = []
    from_profiler = trace_mod.from_profiler

    def with_kernels(*args, **kw):
        tr = from_profiler(*args, **kw)
        t0 = tr.window[0]
        tr.device += [("flash_fwd_bf16_kernel", t0, t0 + K2_US),
                      ("void corr_patch_tile_kernel<1, __nv_bfloat16>", t0, t0 + K3_US)]
        traced.append(tr)
        return tr

    monkeypatch.setattr(trace_mod, "from_profiler", with_kernels)
    res = run()
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert res["attempted"] == 5

    keep = {}
    res = run(traced=True, keep=keep)
    assert res["correct"], res["checked"]
    route, tr = keep["route"], traced[0]
    # The program's spans name the traced call's stages; no tile is pasted.
    host = {n for n, _, _ in tr.host}
    assert {"tpuflow.mof.encode", "tpuflow.mof.corr", "tpuflow.mof.refine"} <= host
    assert "tpuflow.engine.paste" not in host
    assert route.patch_lookups() == (4, 3 * 256, 4, 4, 256)
    work = patch_lookup.k3_per_frame(route)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # No CUDA events on the CPU: the span readers and sk_update read nothing.
    assert set(got) == {"step_mfu_pct", "k2_roofline", "k3_ms_per_frame", "k3_roofline",
                        "device_idle_pct.engine", "upload_idle_ms_per_frame"}
    assert got["k3_ms_per_frame"] == pytest.approx(K3_US / 1e3 / tr.frames, rel=1e-12)
    assert got["k3_roofline"] == pytest.approx(100.0 * counts.least_seconds(*work) * tr.frames / (K3_US / 1e6),
                                               rel=1e-12)


def test_outlier_share_is_kittis_fl():
    # Reference lengths 10, 100, 100 and 0 px, gaps 4, 4, 6 and 2 px: an
    # outlier where the gap passes both 3 px and 5 % of the length.
    ref = np.array([[[10.0, 0.0], [0.0, 100.0], [60.0, 80.0], [0.0, 0.0]]])
    got = ref + np.array([[[4.0, 0.0], [0.0, -4.0], [0.0, 6.0], [2.0, 0.0]]])
    assert plain.flow_outlier_pct(got, ref) == 50.0
    assert plain.flow_outlier_pct(ref, ref) == 0.0


@pytest.mark.parametrize("plant", ["control", "zero_start", "flow_altered"])
def test_planted_fault_or_control_is_caught(plant):
    res = run(patch=faults_mof.PLANTED[plant])
    assert not res["correct"], res["checked"]
