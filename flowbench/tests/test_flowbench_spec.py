"""The harness is driven by data: every file loads, names and units keep to
the allowed characters, every metric's end-to-end metric is reported where
it is listed, and a new cell is found by its name from a file of its own."""

import hashlib
import json
import shutil

import pytest

from flowbench import spec as spec_mod

HOME = spec_mod.HERE
BENCH = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())


def test_every_data_file_loads():
    spec = spec_mod.Spec()
    for kind in ("configs", "workloads", "traffic"):
        files = sorted((HOME / kind).glob("*.json"))
        assert files, kind
        for f in files:
            assert isinstance(json.loads(f.read_text()), dict), f
    for f in sorted((HOME / "metrics").glob("*.py")):
        mod = spec.metric_module(f.stem)
        assert callable(mod.read) and spec_mod.UNIT_RE.match(mod.UNIT), f


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec_mod.NAME_RE.match(n), n
    for w in BENCH["workloads"]:
        assert spec_mod.NAME_RE.match(w["config"]) and spec_mod.NAME_RE.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec_mod.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_each_pair_of_config_and_traffic_names_one_cell():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_cells_name_their_files():
    spec = spec_mod.Spec()
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cell = spec.workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert configs[w["config"]]["file"] == f"flowbench/configs/{w['config']}.json"
        spec.traffic(w["traffic"])
        cfg = spec.config(w["config"])
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
        assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


def test_each_metric_is_reported_where_listed():
    spec = spec_mod.Spec()
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"], m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {e["name"] for e in spec.end_to_end(cell)}, (m["name"], cell)
            assert m["name"] in {p["name"] for p in spec.per_layer(cell)}
    for cell in cells:
        reported = {e["name"] for e in spec.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(cell)


def test_per_layer_follows_each_metrics_list(tmp_path):
    bench = {**BENCH, "workloads": BENCH["workloads"] + [{"name": "other", "config": "memflow-t",
                                                         "traffic": "video-1080p-seg24", "chips": 1, "why": "x"}]}
    bench["end_to_end"] = [{**m, "workloads": m["workloads"] + ["other"]} if "workloads" in m else m
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"][:2] + [{k: v for k, v in BENCH["per_layer"][2].items() if k != "workloads"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = spec_mod.Spec(HOME, tmp_path / "BENCHMARK.json")
    # Listed only for the first cell: not tried in the other; without a list:
    # tried wherever its end-to-end metric is reported.
    assert [m["name"] for m in spec.per_layer("other")] == [BENCH["per_layer"][2]["name"]]
    assert [m["name"] for m in spec.per_layer("memflow-stream-1080p")] == [m["name"] for m in BENCH["per_layer"][:3]]


def digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_is_found_by_its_name_alone(tmp_path):
    home = tmp_path / "flowbench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    cell = json.loads((home / "workloads" / "memflow-stream-1080p.json").read_text())
    (home / "workloads" / "memflow-stream-640x480.json").write_text(json.dumps({**cell, "traffic": "video-640x480"}))
    (home / "traffic" / "video-640x480.json").write_text(json.dumps(
        {**json.loads((home / "traffic" / "video-1080p-seg24.json").read_text()), "width": 640, "height": 480}))
    spec = spec_mod.Spec(home)
    assert spec.workload("memflow-stream-640x480")["traffic"] == "video-640x480"
    assert spec.traffic("video-640x480")["width"] == 640
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    with pytest.raises(FileNotFoundError):
        spec.workload("no-such-cell")
    with pytest.raises(ValueError):
        spec.workload("../BENCHMARK")
