"""The port's host-side modules against the JAX package's on the CPU, its
device rules, and its independence from JAX.

windows, tiles and padding are copies of the JAX package's jax-free
modules; these tests hold each copy to its original on the same inputs.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.core.padding import pad_dims as jax_pad_dims
from tpuflow.runtime import tiles as jax_tiles
from tpuflow.runtime.windows import centered_window_indices as jax_centered

from tpuflow_torch.config import ModelConfig
from tpuflow_torch.core.padding import pad_dims, pad_frames_edge
from tpuflow_torch.runtime import tiles
from tpuflow_torch.runtime.device import device_name, resolve_device
from tpuflow_torch.runtime.engine import RANDOM_INIT, FlowEngine, default_compute_dtype
from tpuflow_torch.runtime.windows import centered_window_indices

REPO = Path(__file__).resolve().parent.parent
TINY = dict(decoder_depth=1, corr_levels=2, corr_radius=2)


@pytest.mark.parametrize("n,length", [(1, 5), (3, 5), (7, 5), (20, 9), (4, 3)])
def test_centered_windows_match_jax(n, length):
    for i in range(n):
        np.testing.assert_array_equal(
            centered_window_indices(n, i, length), jax_centered(n, i, length)
        )


@pytest.mark.parametrize("layout", ["balanced", "reference"])
@pytest.mark.parametrize("w,h,tile", [(1920, 1080, 1280), (176, 72, 96), (3840, 2160, 1280), (256, 96, 96)])
def test_tile_grid_and_groups_match_jax(w, h, tile, layout):
    got = tiles.calculate_tile_grid(w, h, tile, layout=layout)
    ref = jax_tiles.calculate_tile_grid(w, h, tile, layout=layout)
    assert got == ref
    assert tiles.group_tiles_by_shape(got[4]) == jax_tiles.group_tiles_by_shape(ref[4])


def test_main_path_tiles_are_two_960x1080():
    """1920x1080 at the default tile size: two balanced 960x1080 tiles."""
    _, _, cols, rows, info = tiles.calculate_tile_grid(1920, 1080, 1280, layout="balanced")
    assert (cols, rows) == (2, 1)
    assert [(t["x"], t["width"], t["height"]) for t in info] == [(0, 960, 1080), (960, 960, 1080)]


@pytest.mark.parametrize("overlap", [0, 4])
def test_extract_and_paste_match_jax(overlap):
    rng = np.random.default_rng(overlap)
    frames = rng.integers(0, 256, (2, 40, 70, 3), dtype=np.uint8)
    info = jax_tiles.calculate_tile_grid(70, 40, 32, layout="balanced")[4]
    groups = jax_tiles.group_tiles_by_shape(info)
    flows = []
    for idxs in groups.values():
        got = tiles.extract_tile_group(frames, info, idxs, overlap)
        np.testing.assert_array_equal(got, jax_tiles.extract_tile_group(frames, info, idxs, overlap))
        flows += [rng.standard_normal(got.shape[2:4] + (2,)).astype(np.float32) for _ in idxs]
    np.testing.assert_allclose(
        tiles.paste_tile_flows(flows, info, 70, 40, 32, overlap),
        jax_tiles.paste_tile_flows(flows, info, 70, 40, 32, overlap),
        rtol=1e-6, atol=1e-6,
    )


def test_tile_layout_rejects_unknown():
    with pytest.raises(ValueError):
        tiles.resolve_tile_layout("diagonal")


@pytest.mark.parametrize("h,w", [(1080, 960), (72, 88), (61, 77), (8, 8)])
@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_pad_dims_and_edge_pad_match_jax(h, w, mode):
    pads = pad_dims(h, w, 8, mode)
    assert pads == jax_pad_dims(h, w, 8, mode)
    x = np.random.default_rng(h).random((2, h, w, 3), np.float32)
    pt, pb, pl, pr = pads
    ref = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (pt, pb), (pl, pr), (0, 0)), mode="edge"))
    np.testing.assert_array_equal(pad_frames_edge(torch.from_numpy(x), pads).numpy(), ref)


def test_model_config_copy_matches_jax():
    from dataclasses import asdict

    from tpuflow.config import ModelConfig as JaxModelConfig

    for kw in ({}, {"fast_mode": True}, {"dataset": "things", "variant": "noise"}):
        assert asdict(ModelConfig(**kw)) == asdict(JaxModelConfig(**kw))
        assert ModelConfig(**kw).checkpoint_path == JaxModelConfig(**kw).checkpoint_path


def test_cpu_device_and_dtype():
    dev = resolve_device("cpu")
    assert dev.type == "cpu" and device_name(dev) == "cpu"
    assert default_compute_dtype(dev) == torch.float32
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cuda_default_raises_without_a_card(monkeypatch):
    """The entry points default to the card and never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowEngine(ModelConfig(**TINY))


def test_load_model_needs_weights_or_opt_in(tmp_path):
    eng = FlowEngine(ModelConfig(**TINY), device="cpu")
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        eng.load_model(str(tmp_path / "missing.pth"))
    assert not eng.is_model_loaded()
    with pytest.raises(RuntimeError, match="load_model"):
        eng.compute_flows_tiled_stride1(np.zeros((3, 16, 16, 3), np.uint8))


def test_random_init_is_seeded():
    a = FlowEngine(ModelConfig(**TINY), seed=3, device="cpu")
    b = FlowEngine(ModelConfig(**TINY), seed=3, device="cpu")
    assert a.load_model(RANDOM_INIT).startswith("random-init")
    b.load_model(allow_random_init=True)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.model.update_block.aggregator.gamma.item() != 0.0


def test_unported_paths_name_their_slice():
    with pytest.raises(NotImplementedError, match="BOFNet"):
        FlowEngine(ModelConfig(architecture="bof", **TINY), device="cpu")
    with pytest.raises(NotImplementedError, match="cnn"):
        FlowEngine(ModelConfig(encoder="cnn", **TINY), device="cpu")


def test_memflow_names_its_slice():
    """The untiled entry points are VideoFlow's; a MemFlow engine is refused
    at construction with the slice that will bring it."""
    with pytest.raises(NotImplementedError, match="MemFlow"):
        FlowEngine(ModelConfig(model="memflow", **TINY), device="cpu")


def test_port_imports_no_jax():
    """A fresh interpreter that imports the port and runs one CPU forward
    through the engine has neither jax nor tpuflow in sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "from tpuflow_torch.config import ModelConfig\n"
        "from tpuflow_torch.runtime.engine import FlowEngine\n"
        "eng = FlowEngine(ModelConfig(decoder_depth=1, corr_levels=2, corr_radius=2), device='cpu')\n"
        "eng.load_model(allow_random_init=True)\n"
        "frames = np.random.default_rng(0).integers(0, 256, (3, 24, 40, 3), dtype=np.uint8)\n"
        "out = eng.compute_flows_tiled_stride1(frames, tile_size=24)\n"
        "assert out.shape == (3, 24, 40, 2) and np.isfinite(out).all()\n"
        "eng.model.materialize_threshold = 0\n"
        "assert eng.compute_flow(frames, 1).shape == (24, 40, 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpuflow'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
