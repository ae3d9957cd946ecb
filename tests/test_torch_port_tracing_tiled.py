"""The tiled stride-1 path's spans and counters (tpuflow_torch/runtime/
profiling.py) on the CPU, on a small MOF of two 64 x 64 tiles: the
correlation build's and the paste's spans, as registry records and as host
events under torch.profiler; `engine.tiles`, each frame's tiles encoded
once; `corr.dense_bytes`, the dense pyramids' bytes; and with the spans off,
no record and no event pair, the counters still counting."""

import numpy as np
import pytest
import torch

from tests.test_torch_port_tracing import Refuse, fresh_registry, one_torch_thread  # noqa: F401 (autouse)
from tpuflow_torch.config import ModelConfig
from tpuflow_torch.runtime import profiling
from tpuflow_torch.runtime.engine import FlowEngine

MOF = dict(model="videoflow", architecture="mof", encoder="cnn", sequence_length=5, decoder_depth=2,
           corr_levels=2, corr_radius=2)
N, H, W, TILE = 8, 64, 128, 64


@pytest.fixture(scope="module")
def engine():
    eng = FlowEngine(ModelConfig(**MOF), device="cpu", seed=3)
    eng.load_model(allow_random_init=True)
    return eng


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(9).integers(0, 256, (N, H, W, 3), dtype=np.uint8)


def pyramid_bytes(h8: int, w8: int, levels: int, itemsize: int) -> int:
    """One query grid's dense pyramid: every query against each level's
    2x2-pooled plane."""
    return sum(h8 * w8 * (h8 >> lvl) * (w8 >> lvl) * itemsize for lvl in range(levels))


def test_corr_and_paste_spans_name_the_tiled_call(engine, frames):
    from torch.profiler import ProfilerActivity, profile

    clip = frames[:2]
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.compute_flows_tiled_stride1(clip, tile_size=TILE)
    spans = profiling.snapshot()["spans"]
    # One window a frame: one correlation build (both directions) and one
    # refinement in it, and one paste.
    for name in ("tpuflow.mof.corr", "tpuflow.mof.refine", "tpuflow.engine.paste"):
        assert spans[name]["calls"] == len(clip), name
    host = {ev.name for ev in prof.events()}
    assert {"tpuflow.mof.corr", "tpuflow.engine.paste"} <= host


def test_engine_tiles_counts_each_frames_tiles_once(engine, frames, monkeypatch):
    """Each window's refinement sees the tiles encoded so far: the first
    window's three frames (its five frames less the repeated first one),
    then two tiles a frame while frames are left, and each frame's two
    tiles once in all."""
    seen = []
    refine = engine.model.refine
    monkeypatch.setattr(engine.model, "refine",
                        lambda enc: seen.append(profiling.snapshot()["counters"]["engine.tiles"]) or refine(enc))
    engine.compute_flows_tiled_stride1(frames, tile_size=TILE)
    assert seen == [2 * min(N, i + 3) for i in range(N)]
    assert profiling.snapshot()["counters"]["engine.tiles"] == 2 * N


def test_corr_dense_bytes_counts_the_pyramids(engine, frames):
    engine.compute_flows_tiled_stride1(frames, tile_size=TILE)
    itemsize = torch.empty((), dtype=engine.model.corr_dtype).element_size()
    # Per window: two directions, each a pyramid per tile and interior frame.
    per_window = 2 * 2 * (MOF["sequence_length"] - 2) * pyramid_bytes(H // 8, TILE // 8, MOF["corr_levels"], itemsize)
    assert profiling.snapshot()["counters"]["corr.dense_bytes"] == N * per_window


def test_spans_off_record_no_event_pair(engine, frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", Refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    engine.compute_flows_tiled_stride1(frames, tile_size=TILE)
    snap = profiling.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"]["engine.tiles"] == 2 * N and snap["counters"]["engine.frames"] == N
