"""The port's pipeline modules against the JAX package's on the CPU: the ops
(encoders, decoders, TAA, quality and turbulence maps, LODs), the flow
cache and its file names, the native cache IO, video IO, composition and
the TAA classes; and the port's import boundary.

Inputs are made with numpy from a seed and fed to both sides.  Frames are
48x64.  Tolerances, stated per test: every uint8 output equal; float
outputs that the two packages compute in the same order equal, others
within a few f32 ulps of their scale; TAA on the 0-255 scale within 5e-3
(XLA's exp and torch's differ by an ulp or two, and the bilateral weights
are normalized by their sum).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

import tpuflow.pipeline.ops as jops
from tpuflow.pipeline import cache as jcache
from tpuflow.pipeline import compose as jcompose
from tpuflow.pipeline import filenames as jfilenames
from tpuflow.pipeline import taa as jtaa
from tpuflow.pipeline import video_io as jvideo_io
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

import tpuflow_torch.pipeline.ops as ops
from tpuflow_torch.pipeline import cache, compose, filenames, taa, video_io
from tpuflow_torch.runtime import cacheio

REPO = Path(__file__).resolve().parent.parent
H, W = 48, 64
TAA_ATOL = 5e-3


def flow_field(kind: str, seed: int = 0) -> np.ndarray:
    """[H, W, 2] f32: 'rand' (N(0, 40) px), 'small' (within a pixel),
    'special' (rand with +-inf and NaN in the first row), 'zero'."""
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((H, W, 2)) * 40).astype(np.float32)
    if kind == "small":
        flow *= 0.02
    elif kind == "zero":
        flow[:] = 0
    elif kind == "special":
        flow[0, :6] = [[np.inf, 1], [-np.inf, 2], [np.nan, 3], [4, np.nan], [np.inf, -np.inf], [np.nan, np.nan]]
    return flow


def frame(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)


def assert_u8_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---- ops --------------------------------------------------------------------


def test_to_uint8_is_xlas_conversion():
    """NaN to 0, saturation at both ends, truncation: torch's own cast gives
    [253, 44, 0, 0] on the CPU for the first four."""
    x = np.array([-3.7, 300.2, 1e9, np.nan, np.inf, -np.inf, 2.5, 254.99, -0.5], np.float32)
    assert_u8_equal(ops.to_uint8(torch.from_numpy(x)), np.asarray(jnp.asarray(x).astype(jnp.uint8)))


ENCODERS = {
    "hsv": (lambda m, f: m.encode_hsv(f)),
    "gamedev": (lambda m, f: m.encode_gamedev(f, W, H)),
    "rg8": (lambda m, f: m.encode_motion_vectors_rg8(f, 32.0)),
    "rgb8+": (lambda m, f: m.encode_motion_vectors_rgb8(f, 32.0, "rgb+")),
    "rgb8-ycbcr": (lambda m, f: m.encode_motion_vectors_rgb8(f, 32.0, "rgb-ycbcr")),
    "rgb8-dirmag": (lambda m, f: m.encode_motion_vectors_rgb8(f, 32.0, "dir+mag")),
    "colorwheel": (lambda m, f: m.encode_colorwheel(f)),
}


@pytest.mark.parametrize("kind", ["rand", "small", "special", "zero"])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoders_match_jax(name, kind):
    """Every encoder and RGB8 method, on flows inside and far outside each
    clamp range, with +-inf and NaN: uint8 outputs equal."""
    flow = flow_field(kind, seed=1)
    enc = ENCODERS[name]
    assert_u8_equal(enc(ops, flow), enc(jops, flow))


def test_rgb_ycbcr_above_one_saturates():
    """|flow| above the clamp along +x: Y = 0.65, Cb = 0.7, so B = 1.0044
    (256.1 after x255), which JAX writes as 255 and torch's own cast as 0."""
    flow = np.array([[[40.0, 0.0], [-40.0, 0.0]]], np.float32)
    got = ops.encode_motion_vectors_rgb8(flow, 32.0, "rgb-ycbcr")
    assert_u8_equal(got, jops.encode_motion_vectors_rgb8(flow, 32.0, "rgb-ycbcr"))
    assert got[0, 0, 2] == 255


@pytest.mark.parametrize("fmt", ["gamedev", "hsv", "torchvision", "motion-vectors-rg8", "motion-vectors-rgb8"])
def test_encode_flow_dispatch_matches_jax(fmt):
    flow = flow_field("rand", seed=2)
    assert_u8_equal(ops.encode_flow(flow, W, H, fmt, 16.0), jops.encode_flow(flow, W, H, fmt, 16.0))


def test_encode_flow_rejects_unknown_format():
    with pytest.raises(ValueError, match="Unsupported format"):
        ops.encode_flow(flow_field("zero"), W, H, "rgb9")


def test_hsv_to_rgb_matches_jax():
    hsv = frame(3)
    hsv[..., 0] %= 181
    assert_u8_equal(ops.hsv_to_rgb_u8(hsv), jops.hsv_to_rgb_u8(hsv))


@pytest.mark.parametrize("method", ["rgb+", "rgb-ycbcr", "dir+mag"])
def test_decoders_match_jax(method):
    """Both decoders on every uint8 code: the same f32 arithmetic, within an
    ulp of the decoded scale (the rgb+ reciprocal rounds once more or less)."""
    enc = frame(4)
    np.testing.assert_allclose(
        ops.decode_motion_vectors_rg8(enc, 32.0).numpy(), np.asarray(jops.decode_motion_vectors_rg8(enc, 32.0)),
        rtol=0, atol=0,
    )
    got = ops.decode_motion_vectors_rgb8(enc, 32.0, method).numpy()
    ref = np.asarray(jops.decode_motion_vectors_rgb8(enc, 32.0, method))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "kind,use_flow,bilateral",
    [("rand", True, True), ("rand", True, False), ("rand", False, True), ("special", True, True),
     ("special", True, False)],
    ids=["bilateral", "bilinear", "no-flow", "nan-inf-bilateral", "nan-inf-bilinear"],
)
def test_taa_step_matches_jax(kind, use_flow, bilateral):
    """One TAA step on a random history (luminances up to 255 apart, so that
    some bilateral weights underflow and flush to zero as XLA flushes
    them)."""
    cur = frame(5).astype(np.float32)
    hist = np.random.default_rng(6).random((H, W, 3)).astype(np.float32) * 255
    flow = flow_field(kind, seed=7) if use_flow else None
    got = ops.taa_step(cur, flow, hist, alpha=0.1, use_flow=use_flow, use_bilateral=bilateral).numpy()
    ref = np.asarray(jops.taa_step(cur, flow, hist, alpha=0.1, use_flow=use_flow, use_bilateral=bilateral))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TAA_ATOL)


@pytest.mark.parametrize("kind", ["rand", "small", "special"])
def test_quality_maps_match_jax(kind):
    fa, fb, flow = frame(8), frame(9), flow_field(kind, seed=10)
    np.testing.assert_allclose(ops.quality_map(fa, fb, flow).numpy(), np.asarray(jops.quality_map(fa, fb, flow)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ops.quality_map(fa, fb, flow, sign=1.0).numpy(),
                               np.asarray(jops.quality_map(fa, fb, flow, sign=1.0)), rtol=0, atol=1e-6)
    assert_u8_equal(ops.quality_frame(fa, fb, flow), jops.quality_frame(fa, fb, flow))


@pytest.mark.parametrize("ksize", [3, 5])
def test_turbulence_map_matches_jax(ksize):
    """Box-filter sums in another order: within 1e-5 of the map's scale."""
    flow = flow_field("rand", seed=11)
    ref = np.asarray(jops.turbulence_map(flow, ksize))
    np.testing.assert_allclose(ops.turbulence_map(flow, ksize).numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("h,w", [(48, 64), (47, 63), (9, 4), (1, 1)])
def test_lods_match_jax(h, w):
    """lod_downsample on odd and even sides (zero-weight padding), and the
    five-level pyramid: the same f32 sums, equal."""
    flow = flow_field("rand", seed=12)[:h, :w]
    np.testing.assert_array_equal(ops.lod_downsample(flow).numpy(), np.asarray(jops.lod_downsample(flow)))
    got, ref = ops.generate_lods(flow), jops.generate_lods(flow)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("fmt", ["gamedev", "torchvision"])
def test_postprocess_step_matches_jax(fmt):
    flow, cur = flow_field("rand", seed=13), frame(14).astype(np.float32)
    hist = np.random.default_rng(15).random((H, W, 3)).astype(np.float32) * 255
    enc, out = ops.postprocess_step(flow, cur, hist, W, H, fmt)
    jenc, jout = jops.postprocess_step(flow, cur, hist, W, H, fmt)
    assert_u8_equal(enc, jenc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=TAA_ATOL)


# ---- TAA classes ------------------------------------------------------------


def test_taa_processors_match_jax():
    """TAAProcessor over three frames (seeded by the first), the comparison
    processor and the stateless helper, port on the CPU."""
    frames = [frame(20 + i) for i in range(3)]
    flows = [flow_field("small", seed=30 + i) for i in range(3)]
    port, ref = taa.TAAProcessor(device="cpu"), jtaa.TAAProcessor()
    pc, rc = taa.TAAComparisonProcessor(device="cpu"), jtaa.TAAComparisonProcessor()
    for f, fl in zip(frames, flows):
        np.testing.assert_allclose(port.apply_taa(f, fl), ref.apply_taa(f, fl), rtol=0, atol=TAA_ATOL)
        for g, r in zip(pc.apply_comparison(f, fl), rc.apply_comparison(f, fl)):
            np.testing.assert_allclose(g, r, rtol=0, atol=TAA_ATOL)
    np.testing.assert_allclose(port.get_history(), ref.get_history(), rtol=0, atol=TAA_ATOL)
    hist = frames[0].astype(np.float32)
    np.testing.assert_allclose(
        taa.apply_taa_effect(frames[1], flows[1], hist, device="cpu"),
        jtaa.apply_taa_effect(frames[1], flows[1], hist), rtol=0, atol=TAA_ATOL,
    )
    with pytest.raises(ValueError, match="Alpha"):
        port.set_alpha(1.5)
    port.reset_history()
    assert port.get_history() is None


# ---- cache, file names, native cache IO ------------------------------------


def test_flo_bytes_match_jax(tmp_path):
    """.flo from the port's FlowFileHandler, the JAX package's and the port's
    native writer (sync and pooled): identical bytes, read back by both."""
    flow = flow_field("special", seed=40)
    paths = {k: str(tmp_path / f"{k}.flo") for k in ("port", "jax", "native", "pool")}
    cache.FlowFileHandler.save_flow_flo(flow, paths["port"])
    jcache.FlowFileHandler.save_flow_flo(flow, paths["jax"])
    cacheio.write_flo(paths["native"], flow)
    with cacheio.AsyncFloWriter(2) as writer:
        writer.write(paths["pool"], flow)
        assert writer.flush() == 0
    blobs = {k: Path(p).read_bytes() for k, p in paths.items()}
    assert len(set(blobs.values())) == 1 and len(blobs["port"]) == 12 + flow.nbytes
    for read in (cache.FlowFileHandler.load_flow_flo, jcache.FlowFileHandler.load_flow_flo, cacheio.read_flo):
        np.testing.assert_array_equal(read(paths["native"]), flow)


def test_cacheio_builds_into_the_port(tmp_path):
    """The native library is built from the repository's native/cacheio.cpp
    into tpuflow_torch/build/, never into native/build/."""
    assert cacheio.available()
    lib = Path(cacheio.load()._name)
    assert lib.parent == REPO / "tpuflow_torch" / "build" and lib.name.startswith("libcacheio-")
    assert Path(cacheio._SRC) == REPO / "native" / "cacheio.cpp"


@pytest.mark.parametrize("h,w", [(48, 64), (47, 63), (5, 3)])
def test_native_and_numpy_lods_agree(h, w):
    flow = flow_field("rand", seed=41)[:h, :w]
    native = cacheio.lod_pyramid(flow, 5)
    for lods in (cache.LODGenerator.generate_lods(flow, 5), jcache.LODGenerator.generate_lods(flow, 5)):
        assert len(lods) == len(native) == 5
        for a, b in zip(native, lods):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_written_by_one_package_loads_in_the_other(tmp_path, writer, capsys):
    """A cache (npz and flo, LODs) written by one package is complete for,
    loads in, and audits the same in the other's FlowCacheManager."""
    flows = [flow_field("rand", seed=50 + i) for i in range(3)]
    w_mgr, r_mgr = (cache, jcache) if writer == "port" else (jcache, cache)
    w_mgr, r_mgr = w_mgr.FlowCacheManager(), r_mgr.FlowCacheManager()
    d = str(tmp_path / "c")
    for i, fl in enumerate(flows):
        w_mgr.save_flow_to_cache(fl, d, i, "both")
    w_mgr.generate_lods_for_cache(d, 3, progress=False)
    assert r_mgr.check_cache_exists(d, 3) == (True, "npz", [])
    assert r_mgr.check_cache_exists(d, 4) == (False, None, [3])
    assert r_mgr.check_flow_lods_exist(d, 3)
    for i, fl in enumerate(flows):
        for fmt in ("npz", "flo", "auto"):
            np.testing.assert_array_equal(r_mgr.load_cached_flow(d, i, fmt), fl)
        np.testing.assert_array_equal(r_mgr.load_flow_lod(d, i, 2), cache.LODGenerator.generate_lods(fl)[2])
    reports = []
    for mgr in (w_mgr, r_mgr):
        capsys.readouterr()
        mgr.print_lod_cache_statistics(d, 4)
        reports.append(capsys.readouterr().out)
    assert reports[0] == reports[1] and "Frames missing all LODs: 1" in reports[0]


def test_save_optical_flow_files_match_jax(tmp_path):
    flow = flow_field("rand", seed=55)
    for mod, sub in ((cache, "port"), (jcache, "jax")):
        os.makedirs(tmp_path / sub)
        mod.FlowCacheManager().save_optical_flow_files(flow, str(tmp_path / sub / "flow"), 3, "both")
    for ext in ("flo", "npz"):
        name = f"flow_frame_000003.{ext}"
        if ext == "flo":
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        else:
            a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


NAME_CASES = [
    dict(),
    dict(start_time=1.5, duration=2.0, fast_mode=True, tile_mode=True, taa=True),
    dict(start_frame=7, max_frames=12, flow_only=True, flow_format="motion-vectors-rgb8",
         motion_vectors_clamp_range=16.0, uncompressed=True, fps=29.97),
    dict(max_frames=5, flow_only=True, flow_format="hsv", fps=10.0),
    dict(flow_only=True, flow_format="torchvision"),
]
CACHE_CASES = [
    dict(),
    dict(start_frame=4, max_frames=9, sequence_length=7, fast_mode=True, tile_mode=True),
    dict(model="memflow", dataset="kitti"),
    dict(architecture="bof", dataset="sintel", variant="standard", tile_mode=True),
]


@pytest.mark.parametrize("case", range(len(NAME_CASES)))
def test_output_names_match_jax(case, tmp_path):
    kw = NAME_CASES[case]
    src = "/videos/clip.take1.mp4"
    assert filenames.generate_output_filename(src, **kw) == jfilenames.generate_output_filename(src, **kw)
    out = str(tmp_path / "out")
    assert filenames.generate_output_filepath(src, out, **kw) == jfilenames.generate_output_filepath(src, out, **kw)


@pytest.mark.parametrize("case", range(len(CACHE_CASES)))
def test_cache_directories_match_jax(case):
    kw = CACHE_CASES[case]
    src = "/videos/clip.take1.mp4"
    got = filenames.generate_cache_directory(src, **kw)
    assert got == jfilenames.generate_cache_directory(src, **kw)
    fields = dict(start_frame=0, max_frames=1000, sequence_length=5, fast_mode=False, tile_mode=False)
    fields.update(kw)
    assert cache.FlowCacheManager().generate_cache_path(src, **fields) == \
        jcache.FlowCacheManager().generate_cache_path(src, **fields)


# ---- video IO and composition ----------------------------------------------


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An uncompressed 8-frame 96x64 clip of a moving texture and a 640x400
    one (fast mode resizes it)."""
    d = tmp_path_factory.mktemp("io")
    rng = np.random.default_rng(60)
    paths = {}
    for name, (w, h) in (("small", (96, 64)), ("large", (640, 400))):
        path = str(d / f"{name}.avi")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"I420"), 12.0, (w, h))
        base = rng.integers(0, 256, (h, w + 16, 3), dtype=np.uint8)
        for i in range(8):
            out.write(np.ascontiguousarray(base[:, 2 * i : 2 * i + w]))
        out.release()
        paths[name] = path
    return paths


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("which", ["small", "large"])
def test_video_io_matches_jax(clip, which, fast):
    path = clip[which]
    assert video_io.VideoInfo(path).get_info() == jvideo_io.VideoInfo(path).get_info()
    got = video_io.FrameExtractor(path, fast).extract_frames(max_frames=5, start_frame=2, progress=False)
    ref = jvideo_io.FrameExtractor(path, fast).extract_frames(max_frames=5, start_frame=2, progress=False)
    assert got[1:] == ref[1:] and len(got[0]) == len(ref[0]) == 5
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    streamed = list(video_io.FrameStream(path, fast, start_frame=2, max_frames=5))
    for a, b in zip(streamed, ref[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(video_io.FrameExtractor(path, fast).get_frame_at_time(0.25),
                                  jvideo_io.FrameExtractor(path, fast).get_frame_at_time(0.25))
    for wh in ((1920, 1080), (300, 200), (96, 64)):
        assert video_io.fast_mode_dimensions(*wh) == jvideo_io.fast_mode_dimensions(*wh)


def test_video_writer_matches_jax(tmp_path):
    frames = [frame(70 + i) for i in range(3)]
    for mod, name in ((video_io, "port.avi"), (jvideo_io, "jax.avi")):
        with mod.VideoWriter(str(tmp_path / name), 10.0, (W, H), uncompressed=True) as out:
            for f in frames:
                out.write_rgb(f)
    assert (tmp_path / "port.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()


@pytest.mark.parametrize("layout", ["side", "flow-only", "taa", "taa-grid", "grid"])
def test_compose_matches_jax(layout):
    orig, viz = frame(80), frame(81)
    taa_f = np.random.default_rng(82).random((H, W, 3)).astype(np.float32) * 300 - 20
    kw = dict(model_name="MOF_sintel", fast_mode=True, flow_format="hsv")
    if layout == "grid":
        frames = {"Original": orig, "TAA-flow\nalpha 0.1": taa_f, "Flow": viz}
        got = compose.create_video_grid(frames, (2, 2))
        ref = jcompose.create_video_grid(frames, (2, 2))
    else:
        args = {
            "side": dict(),
            "flow-only": dict(flow_only=True),
            "taa": dict(taa_frame=taa_f),
            "taa-grid": dict(taa_frame=taa_f, taa_simple_frame=taa_f[::-1].copy()),
        }[layout]
        got = compose.create_side_by_side(orig, viz, **args, **kw)
        ref = jcompose.create_side_by_side(orig, viz, **args, **kw)
    assert_u8_equal(got, ref)


# ---- the import boundary -----------------------------------------------------


def test_every_module_imports_with_jax_blocked(clip):
    """A fresh interpreter with jax, jaxlib, flax, optax, msgpack and tpuflow
    blocked in sys.modules imports every module of tpuflow_torch (the
    sharding, strips, distributed and checkpoint modules by name too) and runs the
    CLI's --show-tiles report: the port keeps its own copies and needs
    neither msgpack nor optax."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'tpuflow'):\n"
        "    sys.modules[name] = None\n"
        "import tpuflow_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpuflow_torch.__path__, 'tpuflow_torch.')]\n"
        "assert {'tpuflow_torch.runtime.sharding', 'tpuflow_torch.runtime.distributed',\n"
        "        'tpuflow_torch.runtime.checkpoint', 'tpuflow_torch.core.strips'} <= set(mods), mods\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from tpuflow_torch.tools import cli\n"
        f"assert cli.main(['--input', {clip['small']!r}, '--show-tiles']) == 0\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    names = {p.stem for p in (REPO / "tpuflow_torch").rglob("*.py")} - {"__init__"}
    assert int(res.stdout.strip().splitlines()[-1]) >= len(names)
