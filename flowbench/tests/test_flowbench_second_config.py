"""A second configuration's cell fits the harness by new files and list
entries alone: a copy of the benchmark takes VideoFlow MOF's configuration,
a tiled stride-1 route that declares its counts (second_config/, laid over
the copy as new files) and a cell named in the lists of frames_per_s,
step_mfu_pct and k2_roofline; one untraced and one traced run of it finish
on the CPU at a small size, with frames that really tile, the two count
readers give numbers from the route's counts, no other reader runs, and the
program's spans are on in the traced call.  `correct` is not
asserted: the port's MOF starts its motion hidden state from zeros where the
reference starts from the learned one."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from flowbench import counts, harness, spec as spec_mod, trace as trace_mod
from flowbench.tests import small

HOME = spec_mod.HERE
OVERLAY = HOME / "tests" / "second_config"
CELL, CONFIG = "mof-tiled-1080p", "videoflow-mof-t"
LISTED = ("frames_per_s", "step_mfu_pct", "k2_roofline")
SEED = 2**31 + 311
# Two 128 x 128 tiles a frame, two refinement iterations, one clip of the
# window's five frames.
SMALL = {**small.DEPTH,
         "traffic": {**small.TRAFFIC, "width": 256, "segment_frames": 5, "segments": 1},
         "cell": {"tile_size": 128, "check_frames": 1}}
# The CPU runs no K2 kernel: the traced run is given one of this length.
K2_US = 2000.0


def digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """(the copy's root, its digest before the overlay, BENCHMARK.json before)."""
    root = tmp_path_factory.mktemp("bench")
    home = root / "flowbench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(root)
    bench_before = json.loads((root / "BENCHMARK.json").read_text())
    for src in sorted(p for p in OVERLAY.rglob("*") if p.is_file() and "__pycache__" not in p.parts):
        dst = home / src.relative_to(OVERLAY)
        assert not dst.exists(), dst
        shutil.copy(src, dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG, "source": "https://arxiv.org/abs/2303.08340",
                             "file": f"flowbench/configs/{CONFIG}.json", "reduced": [],
                             "why": "VideoFlow MOFNet, Twins-SVT encoders: K1, the SK blocks and K2"})
    cell = json.loads((home / "workloads" / f"{CELL}.json").read_text())
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": cell["traffic"], "chips": 1,
                               "why": cell["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in LISTED:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root, before, bench_before


def test_the_cell_adds_files_and_list_entries_only(copy):
    root, before, bench_before = copy
    after = digest(root)
    changed = {k for k in before if after[k] != before[k]}
    assert changed == {Path("BENCHMARK.json")}
    # BENCHMARK.json less the entries appended to its lists is what it was.
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, old_list in bench_before.items():
        if not isinstance(old_list, list) or not isinstance(old_list[0], dict):
            assert bench[key] == old_list, key
            continue
        for old, new in zip(old_list, bench[key]):
            if "workloads" in old:
                assert new["workloads"][: len(old["workloads"])] == old["workloads"]
                new = {**new, "workloads": old["workloads"]}
            assert new == old, key


def test_the_cells_readers_follow_their_lists(copy):
    spec = spec_mod.Spec(copy[0] / "flowbench")
    assert {m["name"] for m in spec.per_layer(CELL)} == {"step_mfu_pct", "k2_roofline"}
    assert {m["name"] for m in spec.end_to_end(CELL)} == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert len(spec.per_layer("memflow-stream-1080p")) == 10


def test_the_routes_counts_at_1080p(copy):
    spec = spec_mod.Spec(copy[0] / "flowbench")
    run = harness.Run(CELL, SEED, 1, False, "cpu", 0.0, spec)
    route = spec.route_module("mof_tiled_stride1").Route(run)
    assert route.tiling() == (1080, 960, [(0, 0), (0, 960)])
    assert route.aggregation() == (6, 16200, 128, 12)
    assert counts.k2_per_frame(route) == (9_674_588_160_000, 1_194_393_600)


def test_traced_and_untraced_runs_finish(copy, monkeypatch):
    root, before, _ = copy
    spec = spec_mod.Spec(root / "flowbench")
    loaded = []
    metric_module = spec.metric_module
    monkeypatch.setattr(spec, "metric_module", lambda name: loaded.append(name) or metric_module(name))
    traced = []
    from_profiler = trace_mod.from_profiler

    def with_k2(*args, **kw):
        tr = from_profiler(*args, **kw)
        tr.device.append(("flash_fwd_bf16_kernel", tr.window[0], tr.window[0] + K2_US))
        traced.append(tr)
        return tr

    monkeypatch.setattr(trace_mod, "from_profiler", with_k2)

    keep = {}
    res = harness.run_cell(CELL, SEED, 0.001, False, "cpu", spec=spec, overrides=SMALL, keep=keep)
    assert set(res["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert res["attempted"] == 5 and set(res["checked"]) == {"flow_epe_px", "flow_epe_max_px"}

    res = harness.run_cell(CELL, SEED, 0.001, True, "cpu", spec=spec, overrides=SMALL, keep=keep)
    assert sorted(loaded) == ["k2_roofline", "step_mfu_pct"]
    route, tr = keep["route"], traced[0]
    # No reader of this cell reads a span, yet the program's spans name the
    # traced call's stages.
    assert {"tpuflow.mof.encode", "tpuflow.mof.refine"} <= {n for n, _, _ in tr.host}
    assert route.tiling() == (128, 128, [(0, 0), (0, 128)])
    ops = counts.model_flops_per_frame(route)
    work = counts.k2_per_frame(route)
    assert work == counts.aggregation_work(6, 256, 128, 2)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got == {
        "step_mfu_pct": pytest.approx(100.0 * ops * tr.frames / tr.wall_s / counts.BF16_FLOP_PER_S, rel=1e-12),
        "k2_roofline": pytest.approx(100.0 * counts.least_seconds(*work) * tr.frames / (K2_US / 1e6), rel=1e-12),
    }
    after = digest(root)
    assert {k: after[k] for k in before if k.name != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k.name != "BENCHMARK.json"}
