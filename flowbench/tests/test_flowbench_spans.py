"""The readers of the program's spans on hand-built traces: the upload's idle
time with overlapping device events, an annotation's mirror on the device
timeline, uploads that straddle a gap; the span readers on a registry that
holds their span and on one that does not; install and its undo."""

import pytest

from flowbench import spans, spec as spec_mod
from flowbench.trace import Traced

SPEC = spec_mod.Spec()
READERS = ("reader_ms_per_frame", "encode_ms_per_frame", "upload_idle_ms_per_frame")


def reader(name):
    return SPEC.metric_module(name)


def traced(device, host, window=(0.0, 1000.0), frames=2):
    return Traced(frames=frames, wall_s=(window[1] - window[0]) / 1e6, device=device, host=host, window=window)


UP = "tpuflow.engine.upload"


def test_upload_idle_with_overlapping_device_events():
    # Busy [0, 300) from three overlapping kernels, [500, 900), idle
    # [300, 500) and [900, 1000); the upload spans [250, 550) and [950, 1000).
    tr = traced(
        device=[("k1", 0.0, 200.0), ("k2", 100.0, 300.0), ("k3", 150.0, 250.0), ("k4", 500.0, 900.0)],
        host=[(UP, 250.0, 550.0), ("tpuflow.engine.upload.copy", 260.0, 400.0), (UP, 950.0, 1000.0),
              ("aten::add", 0.0, 1000.0)],
    )
    # (200 + 50) us over 2 frames, in ms.
    assert reader("upload_idle_ms_per_frame").read(None, tr) == pytest.approx(0.125)


def test_upload_idle_ignores_annotation_mirrors_on_the_device():
    base = [("k1", 0.0, 400.0), ("k2", 600.0, 1000.0)]
    host = [(UP, 300.0, 700.0)]
    plain = reader("upload_idle_ms_per_frame").read(None, traced(base, host))
    mirrored = base + [("tpuflow.engine.upload", 300.0, 700.0), ("flowbench.traced_call", 0.0, 1000.0)]
    assert plain == pytest.approx(0.1)
    assert reader("upload_idle_ms_per_frame").read(None, traced(mirrored, host)) == pytest.approx(plain)


def test_upload_idle_counts_only_the_part_of_a_gap_inside_the_span():
    # The gap [200, 800) straddles the upload [100, 300): 100 us of it.
    tr = traced(device=[("k", 0.0, 200.0), ("k", 800.0, 1000.0)], host=[(UP, 100.0, 300.0)], frames=1)
    assert reader("upload_idle_ms_per_frame").read(None, tr) == pytest.approx(0.1)
    # Events and spans outside the window are clipped to it.
    tr = traced(device=[("k", -50.0, 200.0)], host=[(UP, 900.0, 1200.0)], window=(0.0, 1000.0), frames=1)
    assert reader("upload_idle_ms_per_frame").read(None, tr) == pytest.approx(0.1)


class FakeRegistry:
    def __init__(self, spans_):
        self.spans, self.on, self.cleared = spans_, False, 0

    def clear(self):
        self.cleared += 1

    def enable(self):
        self.on = True

    def disable(self):
        self.on = False

    def snapshot(self):
        return {"spans": self.spans, "counters": {}}


def test_span_readers_read_device_time_per_frame(monkeypatch):
    reg = FakeRegistry({"tpuflow.memflow.read": {"calls": 4, "host_s": 0.1, "device_s": 0.3},
                        "tpuflow.memflow.encode": {"calls": 4, "host_s": 0.1, "device_s": 0.08}})
    monkeypatch.setattr(spans, "_registry", lambda: reg)
    tr = traced([("k", 0.0, 1.0)], [], frames=4)
    assert reader("reader_ms_per_frame").read(None, tr) == pytest.approx(75.0)
    assert reader("encode_ms_per_frame").read(None, tr) == pytest.approx(20.0)
    undo = spans.install(None)
    assert reg.on and reg.cleared == 1
    undo()
    assert not reg.on


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_their_span(monkeypatch, name):
    tr = traced(device=[("k", 0.0, 200.0)], host=[("tpuflow.engine.upload.copy", 300.0, 400.0)])
    monkeypatch.setattr(spans, "_registry", lambda: FakeRegistry({
        "tpuflow.memflow.read": {"calls": 1, "host_s": 0.1, "device_s": None}}))
    assert reader(name).read(None, tr) is None
    # A program without the registry: nothing installed, nothing read.
    monkeypatch.setattr(spans, "_registry", lambda: None)
    assert spans.install(None) is None
    assert reader(name).read(None, tr) is None


def test_install_turns_the_programs_spans_on_and_off():
    from tpuflow_torch.runtime import profiling

    profiling.count("test.stale")
    undo = spans.install(None)
    try:
        assert profiling._ENABLED and profiling.snapshot()["counters"] == {}
    finally:
        undo()
    assert not profiling._ENABLED
