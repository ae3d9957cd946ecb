"""The port's tools against the JAX package's, on the CPU: the visualizer's
FlowInspector, the GUI launcher's core, the portable builder, the legacy
compat API and the profiling helpers.

The inspectors read a cache like tests/test_tools.py's `video_with_cache`
(five 64x48 frames and their flows), each package in a copy of its own,
since the inspectors write LODs and `_corrected/` files beside the cache.
The clip is written losslessly (FFV1): a smooth texture that does not move
under a small square that does; the flows are 0 but for two corrupted
blocks, so that the correction has a few dozen bad pixels at the default
radii, and the square's take the fine pass.

Tolerances: maps, samples, statistics and file lists equal; the correction
passes as tests/test_torch_port_correction.py holds them (flows within
1e-4, similarities within 1e-6, equal integer targets); the compat compute
routes bit for bit to the port's FlowEngine, which
tests/test_torch_port_engine.py holds to the JAX engine.
"""

import os
import stat
import tarfile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tests.test_torch_port_correction import FLOW_TOL, SIM_TOL, smooth_noise
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from tpuflow import compat as jcompat
from tpuflow.runtime.profiling import flow_statistics as jax_flow_statistics
from tpuflow.tools import gui as jgui
from tpuflow.tools.visualizer import FlowInspector as JaxFlowInspector
from tpuflow_torch import compat
from tpuflow_torch.config import ModelConfig
from tpuflow_torch.pipeline.cache import FlowCacheManager
from tpuflow_torch.runtime.engine import FlowEngine
from tpuflow_torch.runtime import profiling
from tpuflow_torch.runtime.profiling import device_trace, flow_statistics
from tpuflow_torch.tools import gui
from tpuflow_torch.tools import visualizer
from tpuflow_torch.tools.portable import EXCLUDE_SUFFIXES, PortableBuilder
from tpuflow_torch.tools.visualizer import FlowInspector

N, H, W = 5, 48, 64
CACHE = "clip_flow_cache_videoflow_mof_sintel_standard_seq5_start0_frames5"


def write_clip_and_cache(d, seed=0):
    path = str(d / "clip.avi")
    rng = np.random.default_rng(seed)
    base = np.stack([smooth_noise(rng, (H, W), sigma=2.0) for _ in range(3)], -1).clip(0, 255).astype(np.uint8)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 10.0, (W, H))
    assert out.isOpened()
    # A textured square moving right: a square of one colour would give
    # pixels whose candidate targets tie exactly in similarity.
    square = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
    for i in range(N):
        frame = base.copy()
        frame[10:16, 20 + 3 * i : 26 + 3 * i] = square
        out.write(frame)
    out.release()
    cache_dir = str(d / CACHE)
    mgr = FlowCacheManager()
    for i in range(N):
        flow = np.zeros((H, W, 2), np.float32)
        flow[10 + i : 15 + i, 20:25] = [6.0 - i, -4.0]
        flow[30:33, 40:43] = rng.normal(0, 3, (3, 3, 2))
        mgr.save_flow_to_cache(flow, cache_dir, i)
    return path, cache_dir


@pytest.fixture(scope="module")
def inspectors(tmp_path_factory):
    """The JAX and the port's inspector, each over a copy of one clip and
    cache of its own."""
    out = {}
    for side, cls, kw in (("jax", JaxFlowInspector, {}), ("port", FlowInspector, {"device": "cpu"})):
        d = tmp_path_factory.mktemp(f"viz_{side}")
        path, cache_dir = write_clip_and_cache(d)
        out[side] = cls(path, cache_dir, max_frames=N, **kw)
    return out["jax"], out["port"]


def assert_pass_close(got, ref):
    np.testing.assert_array_equal(np.trunc(got["target"]), np.trunc(ref["target"]))
    np.testing.assert_allclose(got["flow"], ref["flow"], rtol=0, atol=FLOW_TOL)
    np.testing.assert_allclose(got["similarity"], ref["similarity"], rtol=0, atol=SIM_TOL)


# ---- FlowInspector ----------------------------------------------------------


def test_inspector_loads_like_jax(inspectors):
    """Files, frames, flows, the LODs generated at preload, statistics."""
    jins, ins = inspectors
    assert ins.device == torch.device("cpu")
    assert [os.path.basename(f) for f in ins.flow_files] == [os.path.basename(f) for f in jins.flow_files]
    assert (ins.width, ins.height, ins.fps) == (jins.width, jins.height, jins.fps)
    assert len(ins.frames) == len(jins.frames) == N + 1
    for a, b in zip(ins.frames, jins.frames):
        np.testing.assert_array_equal(a, b)
    assert sorted(ins.lod_cache) == sorted(jins.lod_cache)
    for key in jins.lod_cache:
        np.testing.assert_array_equal(ins.lod_cache[key], jins.lod_cache[key])
    assert ins.cache_statistics() == jins.cache_statistics()
    assert FlowInspector.find_flow_files(ins.flow_dir) == ins.flow_files


@pytest.mark.parametrize("idx", [0, 3])
def test_inspector_maps_match_jax(inspectors, idx):
    jins, ins = inspectors
    np.testing.assert_array_equal(ins.quality_map(idx), jins.quality_map(idx))
    np.testing.assert_array_equal(ins.quality_map(idx, threshold=0.5), jins.quality_map(idx, threshold=0.5))
    np.testing.assert_array_equal(ins.turbulence_map(idx), jins.turbulence_map(idx))


@pytest.mark.parametrize("xy", [(22, 12), (41, 31), (0, 0), (63, 47)])
def test_inspector_pixel_methods_match_jax(inspectors, xy):
    """sample_flow, pixel_quality, analyze_pixel (coarse and, where the
    coarse similarity is low, fine) and detail_analysis at corrupted,
    clean and corner pixels."""
    jins, ins = inspectors
    x, y = xy
    assert ins.sample_flow(0, x, y) == jins.sample_flow(0, x, y)
    assert ins.pixel_quality(0, x, y) == pytest.approx(jins.pixel_quality(0, x, y), abs=SIM_TOL)
    got, ref = ins.analyze_pixel(0, x, y), jins.analyze_pixel(0, x, y)
    assert_pass_close(got["coarse"], ref["coarse"])
    assert (got["fine"] is None) == (ref["fine"] is None)
    assert ref["fine"] is not None or xy != (22, 12)   # the moving square takes the fine pass
    if ref["fine"] is not None:
        np.testing.assert_array_equal(got["fine"]["target"], ref["fine"]["target"])
        assert_pass_close(got["fine"], ref["fine"])
    got, ref = ins.detail_analysis(0, x, y, patch=16), jins.detail_analysis(0, x, y, patch=16)
    for k in ("pixel", "flow"):
        assert got[k] == ref[k]
    for k in ("source_patch", "target_patch", "corrected_patch"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["corrected_flow"], ref["corrected_flow"], rtol=0, atol=FLOW_TOL)
    for k in ("current_similarity", "corrected_similarity"):
        assert got[k] == pytest.approx(ref[k], abs=SIM_TOL)


def test_inspector_consistency_check_matches_jax(inspectors):
    jins, ins = inspectors
    got, ref = ins.consistency_check(0, 22, 12), jins.consistency_check(0, 22, 12)
    assert got["consistent"] and ref["consistent"]
    assert_pass_close(got["batch"], ref["batch"])


def test_inspector_deferred_quality(inspectors):
    jins, ins = inspectors
    assert ins.quality_map_cached(1) is None
    got = {}
    t = ins.compute_quality_async(1, on_ready=lambda i, q: got.setdefault(i, q))
    t.join(timeout=120)
    assert not t.is_alive()
    np.testing.assert_array_equal(got[1], jins.quality_map(1))
    np.testing.assert_array_equal(ins.quality_map_cached(1), got[1])
    ins.compute_quality_async(1, on_ready=lambda i, q: got.setdefault("again", q))
    assert "again" in got


def test_inspector_correct_range_matches_jax(inspectors):
    """Frames 0-1 corrected by each package into its own `_corrected/`."""
    jins, ins = inspectors
    ref = jins.correct_range(0, 2, progress=False)
    got = ins.correct_range(0, 2, progress=False)
    assert [os.path.basename(r["path"]) for r in got] == [os.path.basename(r["path"]) for r in ref]
    for a, b in zip(got, ref):
        assert a["path"].startswith(ins.flow_dir + "_corrected")
        assert (a["initial_errors"], a["final_errors"]) == (b["initial_errors"], b["final_errors"])
        assert a["final_errors"] < a["initial_errors"]
        np.testing.assert_allclose(a["flow"], b["flow"], rtol=0, atol=FLOW_TOL)
        saved = FlowCacheManager().file_handler.load_flow_npz(a["path"])["flow"]
        np.testing.assert_array_equal(saved, a["flow"])


def test_inspector_defaults_to_the_card(inspectors):
    _, ins = inspectors
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            FlowInspector(ins.video_path, ins.flow_dir, max_frames=N)


def test_run_taa_with_flow_respawns_the_port_cli(monkeypatch):
    calls = []
    monkeypatch.setattr(visualizer.subprocess, "Popen", lambda cmd: calls.append(cmd))
    visualizer.run_taa_with_flow("v.mp4", "cache", ["--fast"])
    assert calls[0][1:] == ["-m", "tpuflow_torch.tools.cli", "--input", "v.mp4", "--use-flow-cache", "cache",
                            "--taa", "--no-autoplay", "--fast"]


# ---- GUI launcher core ---------------------------------------------------------


SETTINGS = [
    dict(input="a.mp4", output="out"),
    dict(input="a.mp4", output="out", fast=True, tile=True, taa=True, frames=50, sequence_length=3,
         model="memflow", stage="kitti", device="cpu", start_frame=4, start_time=1.5, duration=2.0,
         flow_only=True, force_recompute=True, uncompressed=True, skip_lods=True, no_autoplay=True,
         flow_format="motion-vectors-rgb8", motion_vectors_clamp_range=16.0, save_flow="both",
         use_flow_cache="c", vf_dataset="kitti", vf_architecture="bof", vf_variant="noise"),
]


@pytest.mark.parametrize("kw", SETTINGS)
def test_build_command_matches_jax(kw):
    got = gui.build_command(gui.GuiSettings(**kw), python="py")
    ref = jgui.build_command(jgui.GuiSettings(**kw), python="py")
    assert got[:3] == ["py", "-m", "tpuflow_torch.tools.cli"] and ref[2] == "tpuflow.tools.cli"
    assert got[3:] == ref[3:]


def test_settings_roundtrip_and_previews(tmp_path):
    p = str(tmp_path / "settings.json")
    s = gui.GuiSettings(**SETTINGS[1])
    s.save(p)
    assert gui.GuiSettings.load(p) == s
    assert gui.GuiSettings.load(str(tmp_path / "none.json")) == gui.GuiSettings()
    (tmp_path / "bad.json").write_text('{"input": "y.mp4", "bogus_key": 1}')
    assert gui.GuiSettings.load(str(tmp_path / "bad.json")).input == "y.mp4"
    for kw in SETTINGS:
        a, b = gui.GuiSettings(**kw), jgui.GuiSettings(**kw)
        assert gui.preview_output_path(a) == jgui.preview_output_path(b)
        assert gui.preview_cache_path(a) == jgui.preview_cache_path(b)


def test_cache_status_matches_jax(tmp_path):
    path, cache_dir = write_clip_and_cache(tmp_path)
    cases = [dict(input=path, frames=N, use_flow_cache=cache_dir),
             dict(input=path, frames=N + 3, use_flow_cache=cache_dir),
             dict(input=path, frames=N),
             dict(input=str(tmp_path / "none.mp4"), frames=N)]
    for kw in cases:
        assert gui.cache_status(gui.GuiSettings(**kw)) == jgui.cache_status(jgui.GuiSettings(**kw))
    assert gui.cache_status(gui.GuiSettings(**cases[0]))[0] == "complete"
    assert gui.cache_status(gui.GuiSettings(**cases[1]))[0] == "partial"
    p = gui.load_video_preview(path)
    assert p.frame.shape == (H, W, 3) and p.total_frames == N


def test_launch_cli_spawns_the_port_cli(monkeypatch):
    calls = []
    monkeypatch.setattr(gui.subprocess, "Popen", lambda cmd: calls.append(cmd))
    gui.launch_cli(gui.GuiSettings(input="a.mp4"))
    assert calls[0][1:3] == ["-m", "tpuflow_torch.tools.cli"]


# ---- portable builder -------------------------------------------------------------


def test_portable_build_layout(tmp_path):
    out = tmp_path / "dist"
    tar_path = PortableBuilder(output_dir=str(out)).build(tarball=True)
    for rel in ("tpuflow_torch/tools/cli.py", "tpuflow_torch/csrc/corr_patch.cu", "tpuflow_torch/kernels/_build.py",
                "native/cacheio.cpp", "chip_smoke.py"):
        assert (out / rel).is_file(), rel
    assert not (out / "tpuflow").exists() and not (out / "tpuflow_torch" / "build").exists()
    reqs = (out / "requirements.txt").read_text().split()
    assert reqs[0] == "torch" and {"numpy", "opencv-python-headless", "tqdm"} <= set(reqs)
    assert not any("jax" in r or "flax" in r for r in reqs)
    for name, module in (("run_cli.sh", "tpuflow_torch.tools.cli"), ("run_gui.sh", "tpuflow_torch.tools.gui"),
                         ("check_gpu.sh", "chip_smoke.py"), ("setup.sh", "nvcc")):
        script = out / name
        assert script.stat().st_mode & stat.S_IEXEC and script.read_text().startswith("#!"), name
        assert module in script.read_text(), name
    for f in out.rglob("*"):
        assert "__pycache__" not in f.parts
        if f.is_file():
            assert f.suffix not in EXCLUDE_SUFFIXES, f
            assert "jax" not in f.read_text(errors="ignore").split("\n")[0], f
    with tarfile.open(tar_path) as tar:
        assert any(n.endswith("tpuflow_torch/tools/cli.py") for n in tar.getnames())


# ---- compat ---------------------------------------------------------------------------


TINY = dict(encoder="cnn", decoder_depth=2, corr_levels=2, corr_radius=2, feature_dim=64)


@pytest.fixture(scope="module")
def clip_frames():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(6)]


def tiny_engine(model="videoflow", seq=3):
    extra = {"use_rope": True} if model == "memflow" else {}
    return FlowEngine(ModelConfig(model=model, sequence_length=seq, **TINY, **extra), device="cpu")


@pytest.mark.parametrize("model", ["videoflow", "memflow"])
def test_compat_helpers_match_jax(model, clip_frames):
    """prepare_frame_sequence (uint8 and float), validate_frames, the tile
    grid and extract_tile against the JAX classes (their engines are never
    loaded, so nothing compiles)."""
    cls, jcls = ((compat.VideoFlowInference, jcompat.VideoFlowInference) if model == "videoflow"
                 else (compat.MemFlowInference, jcompat.MemFlowInference))
    inf, jinf = cls(sequence_length=3, engine=tiny_engine(model)), jcls(sequence_length=3, engine=object())
    floats = [f.astype(np.float32) / 255 for f in clip_frames]
    for frames in (clip_frames, floats):
        for idx in (0, 2, 5):
            np.testing.assert_array_equal(inf.prepare_frame_sequence(frames, idx),
                                          jinf.prepare_frame_sequence(frames, idx))
    for width, height, size in ((100, 60, 64), (1920, 1080, 1280), (64, 48, 1280)):
        assert inf.calculate_tile_grid(width, height, size) == jinf.calculate_tile_grid(width, height, size)
    _, _, _, _, tiles = inf.calculate_tile_grid(W, H, 40)
    for t in tiles:
        np.testing.assert_array_equal(inf.extract_tile(clip_frames[0], t), jinf.extract_tile(clip_frames[0], t))
    bad = [([], 0), (clip_frames, 99), (clip_frames, -1), ("x", 0), ([np.zeros((4, 4))], 0),
           ([np.zeros((4, 4, 3), np.int16)], 0), ([[1]], 0)]
    for frames, idx in bad:
        with pytest.raises(ValueError) as got:
            inf.validate_frames(frames, idx)
        with pytest.raises(ValueError) as ref:
            jinf.validate_frames(frames, idx)
        assert str(got.value) == str(ref.value)
    for length in (0, 11):
        with pytest.raises(ValueError):
            inf.set_sequence_length(length)
    inf.set_sequence_length(7)
    assert inf.sequence_length == 7


def test_compat_videoflow_routes_equal_the_engine(clip_frames):
    eng = tiny_engine()
    inf = compat.VideoFlowInference(sequence_length=3, engine=eng, allow_random_init=True)
    assert not inf.is_model_loaded() and inf.get_model_info() == {"status": "not_loaded"}
    inf.load_model()
    assert inf.is_model_loaded() and inf.model is eng.model and inf.cfg is eng.config and inf.core is eng
    want = eng.compute_flow(clip_frames, 2)
    np.testing.assert_array_equal(inf.compute_optical_flow(clip_frames, 2), want)
    np.testing.assert_array_equal(inf.compute_optical_flow_with_progress(clip_frames, 2), want)
    np.testing.assert_array_equal(inf.compute_optical_flow_tiled(clip_frames, 2), want)
    inf.set_tile_mode(True)
    np.testing.assert_array_equal(inf.compute_optical_flow_tiled(clip_frames, 2),
                                  eng.compute_flow_tiled(clip_frames, 2))
    info = inf.get_model_info()
    assert info["processor_type"] == "VideoFlowInference" and info["tile_mode"] and info["sequence_length"] == 3
    assert inf.get_memory_usage() == eng.get_memory_usage()
    assert inf.get_device() == torch.device("cpu")
    assert compat.VideoFlowProcessor is compat.VideoFlowInference
    assert compat.MemFlowProcessor is compat.MemFlowInference


def test_compat_memflow_routes_equal_the_engine(clip_frames):
    eng = tiny_engine("memflow")
    inf = compat.MemFlowInference(sequence_length=3, engine=eng, allow_random_init=True)
    inf.load_model()
    np.testing.assert_array_equal(inf.compute_optical_flow(clip_frames, 3), eng.compute_flow(clip_frames, 3))
    np.testing.assert_array_equal(inf.stream_flows(clip_frames[:4]), eng.stream_flows(clip_frames[:4]))
    assert inf.prepare_frame_sequence(clip_frames, 3).shape[1] == 3


def test_compat_device_reaches_the_engine():
    """The device argument goes through DeviceManager into the engine it
    builds ('auto' and 'cuda' need a card); the package exports both
    classes lazily."""
    import tpuflow_torch

    inf = compat.VideoFlowInference(device="cpu", fast_mode=True, sequence_length=3)
    assert inf.engine.device == torch.device("cpu") and inf.engine.config.fast_mode
    assert compat.MemFlowInference(device="cpu", sequence_length=1).engine.config.sequence_length == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            compat.VideoFlowInference()
    with pytest.raises(ValueError, match="tpu"):
        compat.VideoFlowInference(device="tpu")
    assert tpuflow_torch.VideoFlowInference is compat.VideoFlowInference
    assert tpuflow_torch.MemFlowInference is compat.MemFlowInference


# ---- profiling ---------------------------------------------------------------------------


def test_flow_statistics_match_jax():
    rng = np.random.default_rng(12)
    for flow in (rng.normal(0, 7, (H, W, 2)).astype(np.float32), np.zeros((8, 8, 2), np.float32)):
        got = {k: float(v) for k, v in flow_statistics(flow).items()}
        ref = {k: float(v) for k, v in jax_flow_statistics(flow).items()}
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-7), k
    t = flow_statistics(torch.from_numpy(flow))
    assert all(v.device.type == "cpu" and v.dim() == 0 for v in t.values())


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None) as prof:
        assert prof is None
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(logdir.glob("*.pt.trace.json*"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_holds_spans_as_function_events(tmp_path):
    """A span opened under device_trace is a host event of the Chrome trace
    around the work it holds, recorded as a function (cpu_op), not as a user
    annotation, which the profiler would mirror on the device's timeline."""
    import json

    profiling.clear()
    profiling.enable()
    try:
        with device_trace(str(tmp_path)):
            with profiling.span("tpuflow.test.matmul"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        profiling.disable()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    (sp,) = [e for e in events if e["name"] == "tpuflow.test.matmul"]
    assert sp["cat"] == "cpu_op"
    mm = [e for e in events if e["name"] == "aten::mm"]
    assert mm and all(sp["ts"] <= e["ts"] and e["ts"] + e["dur"] <= sp["ts"] + sp["dur"] for e in mm)
    assert profiling.snapshot()["spans"]["tpuflow.test.matmul"]["calls"] == 1
    profiling.clear()