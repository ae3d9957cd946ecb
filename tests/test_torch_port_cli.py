"""The port's FlowPipeline and CLI against the JAX package's, end to end on
the CPU, on a tiny synthetic video (8 frames of 64x48, 6 processed).

Both engines run the tiny configuration of tests/test_pipeline_e2e.py (cnn
encoder, 2 levels, radius 2, 2 iterations, 64 feature channels, T=3; hidden
and context widths 128, the only ones the port's GMA takes) in f32
with f32 volumes, on one random flax param tree per model carried into the
port by `state_dict_from_jax`; the JAX side runs its plain paths
(`dense_lookup='xla'`, `gma_impl='xla'`).  Each package works in a
directory of its own, since both write the same cache directory next to
the video.

Tolerances: cached flows as the engine tests (rtol = atol = 2e-3: two
iterations of feedback through the lookup); flows written by the port
against a direct engine call on the same frames bit for bit; video frames
rendered by the port from the JAX run's cache within 1 of the JAX video's
(uncompressed, so decoding is exact; TAA differs from JAX's by a few f32
ulps, which may move a truncation by one).
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from tpuflow.config import PipelineConfig as JaxPipelineConfig
from tpuflow.core import memflownet as jmem
from tpuflow.core.mofnet import MOFNet as JaxMOFNet
from tpuflow.pipeline.cache import FlowCacheManager as JaxFlowCacheManager
from tpuflow.pipeline.video_io import FrameExtractor
from tpuflow.runtime.convert import unflatten_params
from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
from tpuflow.tools import cli as jcli
from tpuflow.tools import pipeline as jpipeline_module
from tpuflow.tools.pipeline import FlowPipeline as JaxFlowPipeline
from tpuflow.tools.pipeline import create_difference_overlay as jax_difference_overlay
from tests.test_torch_port_model import one_torch_thread, random_flax_params  # noqa: F401 (autouse)

from tpuflow_torch.config import PipelineConfig
from tpuflow_torch.pipeline.cache import FlowCacheManager
from tpuflow_torch.runtime.convert import state_dict_from_jax
from tpuflow_torch.runtime.device import DeviceManager
from tpuflow_torch.runtime.engine import FlowEngine
from tpuflow_torch.tools import cli
from tpuflow_torch.tools import pipeline as pipeline_module
from tpuflow_torch.tools.pipeline import FlowPipeline, create_difference_overlay

REPO = Path(__file__).resolve().parent.parent
H, W, CLIP, N = 48, 64, 8, 6
SEQ = 3
# The port's GMA aggregator has upstream's one width (context 128, no
# output projection), so the tiny models keep the hidden and context widths.
TINY = dict(encoder="cnn", decoder_depth=2, corr_levels=2, corr_radius=2, feature_dim=64)
FLOW_TOL = 2e-3


def write_clip(path: str, n: int = CLIP, w: int = W, h: int = H) -> str:
    """A moving white square on a gradient (tests/test_pipeline_e2e.py),
    uncompressed."""
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"I420"), 10.0, (w, h))
    assert out.isOpened()
    for i in range(n):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[:, :, 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        frame[:, :, 1] = np.linspace(0, 255, h, dtype=np.uint8)[:, None]
        x = 4 + i * 3
        frame[10:20, x : x + 10] = 255
        out.write(frame)
    out.release()
    return path


def read_video(path: str) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


@pytest.fixture(scope="module")
def weights():
    """One random flax param tree each for the tiny MOFNet and MemFlowNet,
    and the JAX engines built on them (one per model, so that each JAX
    function compiles once)."""
    jmof = JaxMOFNet(dtype=jnp.float32, corr_dtype=jnp.float32, dense_lookup="xla", gma_impl="xla",
                     **{k: v for k, v in TINY.items()})
    jmm = jmem.MemFlowNet(use_rope=True, dtype=jnp.float32, corr_dtype=jnp.float32, dense_lookup="xla", **TINY)
    example = (jnp.zeros((1, 2, H, W, 3)), jmm.empty_memory(1, H, W))
    flat_mem = random_flax_params(jmm, seed=41, example=example)
    for key in [k for k in flat_mem if "/flow_head/ffn2_2/" in k]:
        flat_mem[key] = 0.1 * flat_mem[key]
    return {"videoflow": random_flax_params(jmof, seed=40, h=H, w=W), "memflow": flat_mem, "jax_engines": {}}


def engines(weights, config: PipelineConfig):
    """The JAX engine (shared, see `weights`) and a new port engine for
    `config`'s model at the tiny widths, on the same weights, f32 volumes on
    both sides."""
    mcfg = config.model_config()
    flat = weights[mcfg.model]
    jeng = weights["jax_engines"].get(mcfg.model)
    if jeng is None:
        jcfg = dataclasses.replace(JaxPipelineConfig(**dataclasses.asdict(config)).model_config(), **TINY)
        jeng = JaxFlowEngine(jcfg, params=unflatten_params(flat), dtype=jnp.float32)
        jeng.model = jeng.model.clone(corr_dtype=jnp.float32)
        weights["jax_engines"][mcfg.model] = jeng
    eng = FlowEngine(dataclasses.replace(mcfg, **TINY), params=state_dict_from_jax(flat), device="cpu")
    eng.model.corr_dtype = torch.float32
    return jeng, eng


def run_pair(weights, tmp, config: PipelineConfig, name: str, sides=("jax", "port")):
    """process_video with each package in a directory of its own (a copy of
    the clip, an existing output directory).  Returns {side: (pipeline,
    video path, output path)}, and the JAX engine."""
    out = {}
    jeng, eng = engines(weights, config)
    for side, cls, engine, cfg_cls in (("jax", JaxFlowPipeline, jeng, JaxPipelineConfig),
                                       ("port", FlowPipeline, eng, PipelineConfig)):
        if side not in sides:
            continue
        d = tmp / f"{name}_{side}"
        os.makedirs(d / "results")
        video = write_clip(str(d / "clip.avi"))
        cfg = cfg_cls(**{**dataclasses.asdict(config), "input": video, "output": str(d / "results")})
        pipe = cls(cfg, engine=engine)
        out[side] = (pipe, video, pipe.process_video())
    return out, jeng


def cached(pipe, video) -> np.ndarray:
    d = pipe.cache_dir_for(video, 0, N)
    return np.stack([FlowCacheManager().load_cached_flow(d, i) for i in range(N)])


BASE = dict(frames=N, sequence_length=SEQ, no_autoplay=True, allow_random_init=True, device="cpu",
            uncompressed=True, encoder="cnn")


@pytest.mark.parametrize(
    "mode", ["default", "tile", "memflow"],
)
def test_flows_match_jax(weights, tmp_path, mode):
    """The three compute routes the CLI takes by default, with --tile, and
    with --model memflow: cached flows within the engine tests' tolerance
    of the JAX package's; the same cache directory and output names; the
    LODs of each cached flow in the cache.  These frames fit one tile, on
    which route the JAX engine calls no progress_cb and the JAX pipeline's
    --tile fails (ROADMAP.md section 3), so the port's --tile cache is held
    to the JAX engine's compute_flows_tiled_stride1 on the decoded frames."""
    kw = {"default": dict(), "tile": dict(tile=True), "memflow": dict(model="memflow")}[mode]
    sides = ("port",) if mode == "tile" else ("jax", "port")
    runs, jeng = run_pair(weights, tmp_path, PipelineConfig(**BASE, **kw), mode, sides)
    pipe, video, out = runs["port"]
    got = cached(pipe, video)
    if mode == "tile":
        frames, *_ = FrameExtractor(video).extract_frames(max_frames=N, progress=False)
        jeng.load_model()
        ref = jeng.compute_flows_tiled_stride1(frames)
        assert os.path.basename(out) == "clip_6f_tile_10fps_uncompressed_I420.avi"
        assert pipe.cache_dir_for(video, 0, N).endswith("_seq3_start0_frames6_tile")
    else:
        jpipe, jvideo, jout = runs["jax"]
        assert os.path.basename(out) == os.path.basename(jout)
        assert os.path.basename(pipe.cache_dir_for(video, 0, N)) == \
            os.path.basename(jpipe.cache_dir_for(jvideo, 0, N))
        ref = cached(jpipe, jvideo)
    assert got.shape == (N, H, W, 2) and np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, ref, rtol=FLOW_TOL, atol=FLOW_TOL)
    mgr = FlowCacheManager()
    d = pipe.cache_dir_for(video, 0, N)
    assert mgr.check_flow_lods_exist(d, N)
    np.testing.assert_array_equal(mgr.load_flow_lod(d, N - 1, 3), mgr.lod_generator.generate_lods(got[N - 1])[3])
    assert read_video(out).shape == (N, H, 2 * W, 3)


@pytest.mark.parametrize(
    "route", ["batch", "interior", "tile", "memflow"],
)
def test_pipeline_flows_equal_direct_engine_calls(weights, tmp_path, route):
    """compute_all_flows adds nothing to the flows: each route's cache (npz
    and flo) equals the engine's own entry on the same frames, bit for bit,
    with compute_flow_batch in chunks of batch_frames (4 + 2)."""
    kw = {"batch": dict(batch_frames=4), "interior": dict(stride_mode="interior", batch_frames=2),
          "tile": dict(tile=True), "memflow": dict(model="memflow")}[route]
    config = PipelineConfig(**BASE, **kw)
    _, eng = engines(weights, config)
    eng.load_model()
    frames = list((np.random.default_rng(42).random((N, H, W, 3)) * 255).astype(np.uint8))
    pipe = FlowPipeline(config, engine=eng)
    d = str(tmp_path / "cache")
    flows = pipe.compute_all_flows(frames, d, "both", progress=False)
    direct = {
        "batch": lambda: np.concatenate([eng.compute_flow_batch(frames, [0, 1, 2, 3]),
                                         eng.compute_flow_batch(frames, [4, 5])]),
        "interior": lambda: eng.compute_flows_strided(frames, window_batch=2),
        "tile": lambda: eng.compute_flows_tiled_stride1(frames),
        "memflow": lambda: eng.stream_flows(frames),
    }[route]()
    mgr = FlowCacheManager()
    for i in range(N):
        np.testing.assert_array_equal(flows[i], direct[i])
        np.testing.assert_array_equal(mgr.load_cached_flow(d, i, "npz"), direct[i])
        np.testing.assert_array_equal(mgr.load_cached_flow(d, i, "flo"), direct[i])


def render_modes(tmp_path):
    """{mode: config fields} of the render comparisons; 'flow-input' reads
    the RG8 bottom half of the 'flow-only-rg8' video."""
    return {
        "default": dict(),
        "taa": dict(taa=True),
        "flow-only-rg8": dict(flow_only=True, flow_format="motion-vectors-rg8"),
        "hsv-taa": dict(taa=True, flow_format="hsv"),
        "torchvision": dict(flow_format="torchvision"),
        "rgb8": dict(flow_format="motion-vectors-rgb8", motion_vectors_clamp_range=8.0),
        "flow-input": dict(flow_input=str(tmp_path / "flow-only-rg8.avi"), flow_format="motion-vectors-rg8"),
    }


@pytest.fixture(scope="module")
def jax_cache(weights, tmp_path_factory):
    """One JAX run's cache (default route, --save-flow npz) for the render
    comparisons, and the directory it lives in."""
    d = tmp_path_factory.mktemp("jaxcache")
    video = write_clip(str(d / "clip.avi"))
    config = JaxPipelineConfig(**{**BASE, "input": video, "output": str(d), "skip_lods": True})
    jeng, _ = engines(weights, PipelineConfig(**BASE))
    pipe = JaxFlowPipeline(config, engine=jeng)
    pipe.process_video()
    return d, video, pipe.cache_dir_for(video, 0, N)


class RecordingWriter:
    """cv2.VideoWriter that keeps each frame it is given: the I420 codec
    subsamples chroma, so a value that differs by 1 may decode 2 apart."""

    real = cv2.VideoWriter

    def __init__(self, *args):
        self.writer = self.real(*args)
        self.frames = []
        RecordingWriter.last = self

    def isOpened(self):
        return self.writer.isOpened()

    def write(self, frame):
        self.frames.append(frame.copy())
        self.writer.write(frame)

    def release(self):
        self.writer.release()


def test_render_from_shared_cache_matches_jax(weights, jax_cache, tmp_path, monkeypatch):
    """With the JAX run's cache as --use-flow-cache, every frame the port
    writes equals the JAX package's within 1 per value, in every render
    mode: side by side, TAA (2x2), flow-only, other formats and clamp
    ranges, and --flow-input (the 2x3 grid with the decoded external flow);
    the decoded videos have N frames of each mode's size."""
    _, video, cache_dir = jax_cache
    monkeypatch.setattr(cv2, "VideoWriter", RecordingWriter)
    jeng, eng = engines(weights, PipelineConfig(**BASE))
    sizes = {}
    for mode, kw in render_modes(tmp_path).items():
        written = {}
        for side, cls, cfg_cls, engine in (("jax", JaxFlowPipeline, JaxPipelineConfig, jeng),
                                           ("port", FlowPipeline, PipelineConfig, eng)):
            out = str(tmp_path / (mode if side == "jax" else f"{mode}.port")) + ".avi"
            cfg = cfg_cls(**{**BASE, **kw, "input": video, "output": out, "use_flow_cache": cache_dir,
                             "skip_lods": True})
            assert cls(cfg, engine=engine).process_video() == out
            written[side] = np.stack(RecordingWriter.last.frames).astype(int)
            decoded = read_video(out)
            assert decoded.shape == written[side].shape and decoded.shape[0] == N, (mode, side)
        assert np.abs(written["port"] - written["jax"]).max() <= 1, mode
        sizes[mode] = written["port"].shape[1:3]
    assert not eng.is_model_loaded()
    assert sizes["default"] == (H, 2 * W) and sizes["taa"] == (2 * H, 2 * W)
    assert sizes["flow-only-rg8"] == (2 * H, W) and sizes["flow-input"] == (3 * H, 2 * W)


def test_port_finds_the_jax_cache_and_renders_without_the_model(weights, jax_cache, capsys):
    """The port finds the JAX run's cache by its directory name, prints the
    cache-hit message and the LOD audit, and never loads its model."""
    d, video, cache_dir = jax_cache
    _, eng = engines(weights, PipelineConfig(**BASE))
    pipe = FlowPipeline(PipelineConfig(**{**BASE, "input": video, "output": str(d)}), engine=eng)
    capsys.readouterr()
    pipe.process_video()
    out = capsys.readouterr().out
    assert f"Found existing optical flow cache: {cache_dir} (format: npz)" in out
    assert "--- LOD Cache Statistics ---" in out and "Completion rate: 100.0%" in out
    assert not eng.is_model_loaded()


def test_use_flow_cache_errors_match_jax(weights, jax_cache, tmp_path, capsys):
    """A missing and an incomplete --use-flow-cache exit with the JAX
    package's messages; an output path that is itself a cache becomes the
    cache, with the video next to it."""
    _, video, cache_dir = jax_cache
    partial = tmp_path / "partial"
    shutil.copytree(cache_dir, partial)
    os.remove(partial / "flow_frame_000004.npz")
    for where in (str(tmp_path / "missing"), str(partial)):
        msgs = []
        for cls, cfg_cls, side in ((JaxFlowPipeline, JaxPipelineConfig, 0), (FlowPipeline, PipelineConfig, 1)):
            cfg = cfg_cls(**{**BASE, "input": video, "output": str(tmp_path), "use_flow_cache": where})
            capsys.readouterr()
            with pytest.raises(SystemExit):
                cls(cfg, engine=engines(weights, PipelineConfig(**BASE))[side]).process_video()
            err = capsys.readouterr().err
            msgs.append(err[err.index("Error:"):])              # after the progress bars
        assert msgs[0] == msgs[1] and msgs[1].startswith("Error: The specified cache directory")
    as_output = tmp_path / "as_output"
    shutil.copytree(cache_dir, as_output)
    _, eng = engines(weights, PipelineConfig(**BASE))
    out = FlowPipeline(PipelineConfig(**{**BASE, "input": video, "output": str(as_output), "skip_lods": True}),
                       engine=eng).process_video()
    assert out == str(tmp_path / "as_output_taa_output.avi") and os.path.exists(out)
    assert not eng.is_model_loaded()


def test_save_flow_directory_matches_jax(weights, jax_cache, tmp_path):
    """--save-flow both writes the JAX package's `<video>_flow/` files."""
    _, video, cache_dir = jax_cache
    names = []
    for cls, cfg_cls, side in ((JaxFlowPipeline, JaxPipelineConfig, 0), (FlowPipeline, PipelineConfig, 1)):
        out = tmp_path / f"side{side}"
        os.makedirs(out)
        cfg = cfg_cls(**{**BASE, "input": video, "output": str(out), "use_flow_cache": cache_dir,
                         "save_flow": "both", "skip_lods": True})
        path = cls(cfg, engine=engines(weights, PipelineConfig(**BASE))[side]).process_video()
        flow_dir = Path(path).with_name(Path(path).stem + "_flow")
        names.append(sorted(p.name for p in flow_dir.iterdir()))
        if side:
            np.testing.assert_array_equal(FlowCacheManager().file_handler.load_flow_flo(
                str(flow_dir / "flow_frame_000002.flo")), FlowCacheManager().load_cached_flow(cache_dir, 2))
    assert names[0] == names[1] and len(names[0]) == 2 * N


def test_difference_overlay_matches_jax():
    rng = np.random.default_rng(43)
    a = rng.standard_normal((120, 90, 2)).astype(np.float32) * 3
    b = a + rng.standard_normal((120, 90, 2)).astype(np.float32) * 2
    np.testing.assert_array_equal(create_difference_overlay(a, b), jax_difference_overlay(a, b))


# ---- the CLI -----------------------------------------------------------------


def parser_table(parser) -> list:
    return [(tuple(a.option_strings), a.dest, a.default, a.choices, a.type, a.nargs, a.const)
            for a in parser._actions]


# Flags of the port's CLI that the JAX CLI has not: they leave the
# pipeline's configuration as it is.
PORT_ONLY_FLAGS = (("--trace-dir",),)


def test_parser_and_config_match_jax():
    """Every flag, default and choice of the JAX CLI, and args_to_config's
    fields and model_config() for a set of flag combinations; the port's own
    flags come last."""
    port = parser_table(cli.build_parser())
    assert [row for row in port if row[0] not in PORT_ONLY_FLAGS] == parser_table(jcli.build_parser())
    assert tuple(row[0] for row in port[-len(PORT_ONLY_FLAGS):]) == PORT_ONLY_FLAGS
    assert dataclasses.asdict(PipelineConfig()) == dataclasses.asdict(JaxPipelineConfig())
    for argv in ([], ["--tile", "--fast", "--taa", "--model", "memflow", "--stage", "kitti", "--save-flow", "both"],
                 ["--vf-architecture", "bof", "--vf-dataset", "things", "--vf-variant", "noise", "--encoder", "cnn",
                  "--batch-frames", "2", "--stride-mode", "interior", "--sequence-length", "7", "--device", "cpu"]):
        got = cli.args_to_config(cli.build_parser().parse_args(argv))
        ref = jcli.args_to_config(jcli.build_parser().parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert dataclasses.asdict(got.model_config()) == dataclasses.asdict(ref.model_config())


def test_show_tiles_matches_jax(tmp_path, capsys):
    video = write_clip(str(tmp_path / "wide.avi"), n=2, w=1920, h=1080)
    reports = []
    for mod in (jcli, cli):
        capsys.readouterr()
        assert mod.main(["--input", video, "--show-tiles"]) == 0
        reports.append(capsys.readouterr().out)
    assert reports[0] == reports[1] and "2 tiles of 960x1080" in reports[1]


def test_cli_refuses_what_is_not_ported(tmp_path):
    """--num-processes > 1 without a coordinator (argument or MASTER_ADDR and
    MASTER_PORT) raises ValueError before any process group starts (the
    multi-process pass itself is tests/test_torch_port_distributed.py's); a
    missing input returns 1; 'auto' and 'cuda' without a card
    (--interactive included) and 'tpu' raise; data_parallel on the CPU
    builds no mesh."""
    video = write_clip(str(tmp_path / "c.avi"), n=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            cli.main(["--input", video, "--interactive"])
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(["--input", video, "--num-processes", "2", "--process-id", "0", "--device", "cpu"])
    assert FlowPipeline(PipelineConfig(**BASE, data_parallel=4)).engine.mesh is None
    assert cli.main(["--input", str(tmp_path / "none.mp4")]) == 1
    assert DeviceManager.get_device("cpu") == torch.device("cpu")
    assert DeviceManager.get_device_info("cpu") == {"device": "cpu", "device_count": 1, "devices": ["cpu"]}
    if not torch.cuda.is_available():
        for dev in ("auto", "cuda"):
            with pytest.raises(RuntimeError, match="No CUDA device"):
                FlowPipeline(PipelineConfig(device=dev))
    with pytest.raises(ValueError, match="tpu"):
        DeviceManager.get_device("tpu")


def test_cli_module_runs_on_the_cpu(tmp_path):
    """`python3 -m tpuflow_torch.tools.cli ... --device cpu` at the full
    widths (cnn encoder, fast mode: 6 iterations, 3 levels, radius 3) on a
    128x96 clip: the video, the cache and its LODs."""
    video = write_clip(str(tmp_path / "c.avi"), n=4, w=128, h=96)
    os.makedirs(tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "tpuflow_torch.tools.cli", "--input", video, "--output", str(tmp_path / "out"),
         "--frames", "4", "--sequence-length", "3", "--encoder", "cnn", "--fast", "--taa", "--device", "cpu",
         "--allow-random-init", "--no-autoplay", "--save-flow", "npz"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[Model] MOF_sintel on cpu" in res.stdout and "Completion rate: 100.0%" in res.stdout
    out = tmp_path / "out" / "c_4f_fast_taa_10fps_MJPG.avi"
    assert read_video(str(out)).shape == (4, 192, 256, 3)
    cache_dir = tmp_path / "c_flow_cache_videoflow_mof_sintel_standard_seq3_start0_frames4_fast"
    assert FlowCacheManager().check_flow_lods_exist(str(cache_dir), 4)


@pytest.mark.parametrize("cache", ["complete", "incomplete"])
def test_interactive_matches_jax(weights, tmp_path, monkeypatch, capsys, cache):
    """--interactive through each package's CLI, in a directory of its own,
    without a display: with a complete cache (the same flows written by each
    package's cache manager, no LODs: the inspector makes them) and with an
    incomplete one (two of six flows: the pipeline computes them all first,
    with the tiny engines).  Both return 1 and print the cache statistics;
    the statistics are equal, but for the byte counts of flows each package
    computed itself (compressed; the flows agree within FLOW_TOL)."""
    monkeypatch.delenv("DISPLAY", raising=False)
    config = PipelineConfig(**BASE)
    jeng, eng = engines(weights, config)
    monkeypatch.setattr(jpipeline_module, "FlowPipeline", lambda cfg: JaxFlowPipeline(cfg, engine=jeng))
    monkeypatch.setattr(pipeline_module, "FlowPipeline", lambda cfg: FlowPipeline(cfg, engine=eng))
    flows = np.random.default_rng(44).normal(0, 2, (N, H, W, 2)).astype(np.float32)
    out = {}
    for side, mod, mgr in (("jax", jcli, JaxFlowCacheManager()), ("port", cli, FlowCacheManager())):
        d = tmp_path / side
        os.makedirs(d / "results")
        video = write_clip(str(d / "clip.avi"))
        cache_dir = FlowPipeline(config.replace(input=video), engine=eng).cache_dir_for(video, 0, N)
        for i in range(N if cache == "complete" else 2):
            mgr.save_flow_to_cache(flows[i], cache_dir, i)
        capsys.readouterr()
        rc = mod.main(["--input", video, "--output", str(d / "results"), "--frames", str(N), "--sequence-length",
                       str(SEQ), "--encoder", "cnn", "--device", "cpu", "--allow-random-init", "--no-autoplay",
                       "--uncompressed", "--interactive"])
        text = capsys.readouterr().out
        stats = ast.literal_eval(text.split("Cache statistics: ")[1].splitlines()[0])
        out[side] = (rc, stats, text, np.stack([FlowCacheManager().load_cached_flow(cache_dir, i) for i in range(N)]))
    (jrc, jstats, jtext, jflows), (rc, stats, text, got) = out["jax"], out["port"]
    assert rc == jrc == 1
    for t in (text, jtext):
        assert "Cannot start Tk visualizer" in t and "--- LOD Cache Statistics ---" in t
        assert ("Cache incomplete (4 frames missing)" in t) == (cache == "incomplete")
    assert stats["frames"] == N and stats["complete_lods"]
    if cache == "complete":
        assert stats == jstats
        np.testing.assert_array_equal(got, flows)
    else:
        drop = ("flow_bytes", "lod_bytes")
        assert {k: v for k, v in stats.items() if k not in drop} == {k: v for k, v in jstats.items() if k not in drop}
        np.testing.assert_allclose(got, jflows, rtol=FLOW_TOL, atol=FLOW_TOL)
