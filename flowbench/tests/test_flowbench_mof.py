"""The tiled MOF cell, mof-tiled-stride1-1080p: its readers follow their
lists, its route's counts at 1080p are pinned, and its runs on the CPU at a
small size (two 128 x 128 tiles, two refinement iterations, one clip of
five frames) are correct untraced and traced, while faults_mof.py's plants
are caught.

The cell's limits are in pixels at 1080p on the card in bfloat16; here the
program runs in float32 (it reads about 1e-3 px of a mean flow near 2.7 px)
and is held to limits of this size, SMALL_LIMITS.  The plants read 0.16 px
(zero start), 0.18 px (the fp8 control) and 22 px at a pixel (a flow moved
by 16 px), each several times over them."""

import pytest

from flowbench import counts, faults_mof, harness, spec as spec_mod, trace as trace_mod
from flowbench.counts import lookup
from flowbench.tests import small

CELL = "mof-tiled-stride1-1080p"
SEED = 2**31 + 311
SMALL_LIMITS = {"flow_epe_px": 0.02, "flow_epe_max_px": 0.1}
SMALL = {**small.DEPTH,
         "traffic": {**small.TRAFFIC, "width": 256, "segment_frames": 5, "segments": 1},
         "cell": {"tile_size": 128, "check_frames": 1, "limits": SMALL_LIMITS}}
# The CPU runs no K1 or K2 kernel: the traced run is given one of each.
K1_US, K2_US = 1500.0, 2000.0
MEMFLOW_READERS = {"step_mfu_pct", "sk_update_ms_per_frame", "k2_roofline", "k3_ms_per_frame",
                   "device_idle_pct.engine", "reader_ms_per_frame", "encode_ms_per_frame",
                   "upload_idle_ms_per_frame", "k3_roofline", "k9_roofline"}
MOF_READERS = {"step_mfu_pct", "k2_roofline", "sk_update_ms_per_frame", "device_idle_pct.engine",
               "upload_idle_ms_per_frame", "k1_roofline", "mof_corr_ms_per_frame", "mof_refine_ms_per_frame",
               "mof_encode_ms_per_frame"}


def run(traced=False, patch=None, keep=None):
    return harness.run_cell(CELL, SEED, 0.001, traced, "cpu", overrides=SMALL, patch=patch, keep=keep)


def test_the_cells_readers_follow_their_lists():
    spec = spec_mod.Spec()
    assert {m["name"] for m in spec.per_layer(CELL)} == MOF_READERS
    assert {m["name"] for m in spec.end_to_end(CELL)} == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in spec.per_layer("memflow-stream-1080p")} == MEMFLOW_READERS


def test_the_routes_counts_at_1080p():
    spec = spec_mod.Spec()
    r = harness.Run(CELL, SEED, 1, False, "cpu", 0.0, spec)
    route = spec.route_module(r.cell["route"]).Route(r)
    assert route.tiling() == (1080, 960, [(0, 0), (0, 960)])
    assert route.aggregation() == (6, 16200, 128, 12)
    assert counts.k2_per_frame(route) == (9_674_588_160_000, 1_194_393_600)
    # Both encoders on one frame's 2 tiles, and a window's correlation,
    # refinement and upsample: 1.87e12 under a whole window through the
    # reference, whose encoders see 10 tile-frames and 6.
    assert counts.model_flops_per_frame(route) == 23_097_916_784_640
    # 12 iterations x 2 directions; 2 tiles x 3 interior frames x 135 x 120.
    assert route.lookups() == (24, 97_200, 4, 4)
    # A query: 4 levels of a 10 x 10 bf16 window and 81 bf16 features, and
    # its f32 flow: 1 456 bytes.
    assert lookup.lookup_bytes(1, 1, 4, 4) == 1_456
    assert lookup.k1_bytes_per_frame(route) == 3_396_556_800
    assert counts.least_seconds(0, 3_396_556_800) == pytest.approx(1.01390e-3, rel=1e-5)


def test_untraced_and_traced_runs_are_correct(monkeypatch):
    traced = []
    from_profiler = trace_mod.from_profiler

    def with_kernels(*args, **kw):
        tr = from_profiler(*args, **kw)
        t0 = tr.window[0]
        tr.device += [("void dense_lookup_kernel<__nv_bfloat16>", t0, t0 + K1_US),
                      ("flash_fwd_bf16_kernel", t0, t0 + K2_US)]
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
    # The program's spans name the traced call's stages.
    assert {"tpuflow.mof.encode", "tpuflow.mof.corr", "tpuflow.mof.refine",
            "tpuflow.engine.paste"} <= {n for n, _, _ in tr.host}
    nbytes = lookup.k1_bytes_per_frame(route)
    assert route.lookups() == (4, 6 * 256, 4, 4)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # No CUDA events on the CPU: the span readers and sk_update read nothing.
    assert set(got) == {"step_mfu_pct", "k2_roofline", "device_idle_pct.engine", "upload_idle_ms_per_frame",
                        "k1_roofline"}
    assert got["k1_roofline"] == pytest.approx(100.0 * counts.least_seconds(0, nbytes) * tr.frames / (K1_US / 1e6),
                                               rel=1e-12)


@pytest.mark.parametrize("plant", ["control", "zero_start", "flow_altered"])
def test_planted_fault_or_control_is_caught(plant):
    res = run(patch=faults_mof.PLANTED[plant])
    assert not res["correct"], res["checked"]
