"""The port's tracing registry (tpuflow_torch/runtime/profiling.py) on the
CPU: spans off and on, nesting, threads, counters, snapshot and clear; the
program's spans on a small MemFlow stream (per-frame counts, flows bit for
bit with tracing off); spans as host events under torch.profiler; the
kernels' launch counters; and the CLI's --trace-dir on a tiny clip."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tpuflow_torch.config import ModelConfig
from tpuflow_torch.kernels import _build
from tpuflow_torch.kernels.denselookup import dense_lookup
from tpuflow_torch.runtime import profiling
from tpuflow_torch.runtime.engine import FlowEngine

MEMFLOW = dict(model="memflow", use_rope=True, encoder="cnn", decoder_depth=2, corr_levels=2, corr_radius=2)
FRAMES, H, W = 3, 64, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test starts and ends with the registry empty and tracing off."""
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


class Refuse:
    """Stands in for what a span must not create while tracing is off."""

    def __init__(self, *args, **kwargs):
        raise AssertionError("created while tracing is off")


@profiling.span("tpuflow.test.outer")
def outer(n):
    with profiling.span("tpuflow.test.inner"):
        time.sleep(0.002)
    return inner_twice(n) + 1


@profiling.span("tpuflow.test.inner")
def inner_twice(n):
    return 2 * n


def test_off_records_nothing_and_creates_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "_RANGE", Refuse)
    monkeypatch.setattr(profiling, "_open", Refuse)
    monkeypatch.setattr(torch.cuda, "Event", Refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert outer(3) == 7
    with profiling.span("tpuflow.test.cm"):
        pass
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


def test_spans_nest_as_decorators_and_context_managers():
    profiling.enable()
    assert outer(3) == 7
    assert outer(4) == 9
    spans = profiling.snapshot()["spans"]
    assert set(spans) == {"tpuflow.test.outer", "tpuflow.test.inner"}
    assert spans["tpuflow.test.outer"]["calls"] == 2 and spans["tpuflow.test.inner"]["calls"] == 4
    assert spans["tpuflow.test.outer"]["host_s"] >= spans["tpuflow.test.inner"]["host_s"] >= 0.004
    # No CUDA here: no event pair, so no device time.
    assert spans["tpuflow.test.outer"]["device_s"] is None


def test_a_span_entered_off_and_left_on_records_nothing():
    cm = profiling.span("tpuflow.test.cm")
    with cm:
        profiling.enable()
    assert profiling.snapshot()["spans"] == {}
    with cm:
        with cm:
            pass
    assert profiling.snapshot()["spans"]["tpuflow.test.cm"]["calls"] == 2


def test_spans_and_counters_from_many_threads():
    profiling.enable()
    cm = profiling.span("tpuflow.test.cm")
    errors = []

    def work():
        try:
            for _ in range(200):
                with cm:
                    outer(1)
                profiling.count("test.items", 2)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    snap = profiling.snapshot()
    assert snap["spans"]["tpuflow.test.cm"]["calls"] == 1600
    assert snap["spans"]["tpuflow.test.outer"]["calls"] == 1600
    assert snap["spans"]["tpuflow.test.inner"]["calls"] == 3200
    assert snap["counters"] == {"test.items": 3200}
    assert profiling._CM_OPEN == 0


def test_counters_count_on_and_off_and_records_outlive_disable():
    profiling.count("test.a")
    profiling.count("test.a", 4)
    profiling.enable()
    outer(1)
    profiling.count("test.b", 7)
    profiling.disable()
    outer(1)
    profiling.count("test.b")
    snap = profiling.snapshot()
    assert snap["counters"] == {"test.a": 5, "test.b": 8}
    assert snap["spans"]["tpuflow.test.outer"]["calls"] == 1
    snap["counters"]["test.a"] = 0
    assert profiling.snapshot()["counters"]["test.a"] == 5
    profiling.clear()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


class FakeEvent:
    """A CUDA event on a clock the test moves: complete once the clock has
    passed the time it was recorded at plus `lag`."""

    clock = 0.0
    lag = 1.0
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made.append(self)

    def record(self):
        self.t = FakeEvent.clock

    def query(self):
        return FakeEvent.clock >= self.t + FakeEvent.lag

    def synchronize(self):
        FakeEvent.clock = max(FakeEvent.clock, self.t + FakeEvent.lag)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return 1e3 * (end.t - self.t)


def test_device_time_from_event_pairs_resolved_as_they_complete(monkeypatch):
    """Event pairs are folded in once query() finds them complete (so few are
    held), the rest by snapshot(); device seconds are the pairs' elapsed
    times."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.clock, FakeEvent.made = 0.0, []
    cm = profiling.span("tpuflow.test.dev")
    profiling.enable()
    for _ in range(5):
        with cm:
            FakeEvent.clock += 0.25
    assert len(FakeEvent.made) == 10
    # The first pairs completed while later spans closed.
    assert 0 < len(profiling._pending) < 5
    s = profiling.snapshot()["spans"]["tpuflow.test.dev"]
    assert not profiling._pending
    assert s["calls"] == 5 and s["device_s"] == pytest.approx(1.25)


def test_stream_flows_spans_per_frame_and_flows_unchanged():
    eng = FlowEngine(ModelConfig(**MEMFLOW), device="cpu")
    eng.load_model(allow_random_init=True)
    frames = np.random.default_rng(0).integers(0, 256, (FRAMES, H, W, 3), dtype=np.uint8)
    off = eng.stream_flows(frames)
    profiling.clear()
    profiling.enable()
    on = eng.stream_flows(frames)
    profiling.disable()
    np.testing.assert_array_equal(on, off)
    snap = profiling.snapshot()
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    for name in ("tpuflow.engine.upload", "tpuflow.engine.upload.copy", "tpuflow.engine.upload.prep",
                 "tpuflow.engine.fetch_wait", "tpuflow.engine.deliver", "tpuflow.memflow.encode",
                 "tpuflow.memflow.read", "tpuflow.memflow.refine", "tpuflow.memflow.write"):
        assert calls.pop(name) == FRAMES, name
    assert calls.pop("tpuflow.sk.update") == FRAMES * (MEMFLOW["decoder_depth"] + 1)
    assert calls == {}
    assert snap["counters"]["engine.frames"] == FRAMES
    assert snap["counters"]["engine.upload_bytes"] == frames.nbytes
    # Nothing reaches the host from a card here.
    assert "engine.fetch_bytes" not in snap["counters"]
    spans = snap["spans"]
    assert spans["tpuflow.engine.upload"]["host_s"] >= spans["tpuflow.engine.upload.prep"]["host_s"]
    assert spans["tpuflow.memflow.refine"]["host_s"] >= spans["tpuflow.sk.update"]["host_s"]


def test_spans_are_host_events_inside_the_profiled_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = FlowEngine(ModelConfig(**MEMFLOW), device="cpu")
    eng.load_model(allow_random_init=True)
    frames = np.random.default_rng(1).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.range"):
            eng.stream_flows(frames)
    profiling.disable()
    events = prof.events()
    (rng,) = [e.time_range for e in events if e.name == "test.range"]
    ours = [e for e in events if e.name.startswith("tpuflow.")]
    assert {e.name for e in ours} == set(profiling.snapshot()["spans"])
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)
    assert all(rng.start <= e.time_range.start <= e.time_range.end <= rng.end for e in ours)
    by = {}
    for e in ours:
        by.setdefault(e.name, []).append(e.time_range)
    # Each copy lies inside an upload.
    for c in by["tpuflow.engine.upload.copy"]:
        assert any(u.start <= c.start and c.end <= u.end for u in by["tpuflow.engine.upload"])
    assert len(by["tpuflow.memflow.read"]) == 2


def test_count_launch_feeds_the_registry():
    _build.count_launch(dense_lookup)
    _build.count_launch(dense_lookup)
    assert profiling.snapshot()["counters"] == {"kernels.dense_lookup.launches": 2}
    assert not hasattr(dense_lookup, "launches")


def test_report_lists_spans_and_counters():
    profiling.enable()
    outer(1)
    profiling.count("engine.frames", 2)
    table = profiling.report(frames=2)
    lines = table.splitlines()
    assert lines[0].split()[:4] == ["span", "calls", "host", "s"]
    assert lines[1].startswith("tpuflow.test.outer") and "engine.frames" in lines[-1]
    assert len(lines) == 4


def test_cli_trace_dir_writes_the_trace_and_spans(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    from tpuflow_torch.tools import cli

    video = str(tmp_path / "clip.avi")
    out = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"I420"), 10.0, (64, 48))
    for i in range(3):
        frame = np.zeros((48, 64, 3), np.uint8)
        frame[10:20, 4 + 3 * i : 14 + 3 * i] = 255
        out.write(frame)
    out.release()
    (tmp_path / "out").mkdir()
    trace_dir = tmp_path / "trace"
    rc = cli.main(["--input", video, "--output", str(tmp_path / "out"), "--frames", "3",
                   "--sequence-length", "3", "--encoder", "cnn", "--fast", "--device", "cpu",
                   "--allow-random-init", "--no-autoplay", "--skip-lods", "--flow-only",
                   "--trace-dir", str(trace_dir)])
    assert rc == 0
    spans = json.loads((trace_dir / "spans.json").read_text())
    assert spans["counters"]["engine.frames"] == 3
    assert spans["per_frame"]["frames"] == 3
    for name in ("tpuflow.engine.upload", "tpuflow.mof.encode", "tpuflow.mof.refine", "tpuflow.sk.update",
                 "tpuflow.engine.fetch_wait"):
        assert spans["spans"][name]["calls"] > 0, name
        assert spans["per_frame"]["spans"][name]["host_ms"] > 0
    assert spans["spans"]["tpuflow.sk.update"]["device_s"] is None
    (trace,) = trace_dir.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"tpuflow.mof.refine", "tpuflow.engine.upload"} <= names
    printed = capsys.readouterr().out
    assert "tpuflow.mof.refine" in printed and "engine.frames" in printed
    # The pass alone is traced: tracing is off again afterwards.
    assert not profiling._ENABLED
