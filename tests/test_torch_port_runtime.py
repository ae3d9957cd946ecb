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

from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("model", ["videoflow", "memflow"])
def test_cuda_default_raises_without_a_card(monkeypatch, model):
    """The entry points default to the card and never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowEngine(ModelConfig(model=model, **TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowEngine(ModelConfig(model=model, **TINY), device="cuda")


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
    """BOF and the cnn encoder, once refused as later slices, build now (and
    MemFlow: test_memflow_engine_builds_and_videoflow_does_not_stream)."""
    from tpuflow_torch.core.encoders import BasicEncoder
    from tpuflow_torch.core.mofnet import BOFNet

    assert type(FlowEngine(ModelConfig(architecture="bof", **TINY), device="cpu").model) is BOFNet
    model = FlowEngine(ModelConfig(encoder="cnn", **TINY), device="cpu").model
    assert isinstance(model.fnet, BasicEncoder) and isinstance(model.cnet, BasicEncoder)
    assert isinstance(model.cnet.norm1, torch.nn.Identity)      # the stem's norm: 'instance' only


@pytest.mark.parametrize(
    "cfg", [dict(architecture="bof", sequence_length=3), dict(architecture="bof"), dict(encoder="cnn")],
    ids=["bof-T3", "bof-T5", "cnn"],
)
def test_every_entry_point_runs(cfg):
    """A BOF or cnn engine with random weights through every VideoFlow entry
    point on a small clip: 24x40 frames, two 24x24 tiles at tile_size=24."""
    eng = FlowEngine(ModelConfig(**cfg, **TINY), device="cpu")
    eng.load_model(allow_random_init=True)
    frames = np.random.default_rng(5).integers(0, 256, (5, 24, 40, 3), dtype=np.uint8)
    outs = {
        "compute_flow": eng.compute_flow(frames, 2)[None],
        "compute_flow_batch": eng.compute_flow_batch(frames, [0, 4]),
        "compute_flows_strided": eng.compute_flows_strided(frames),
        "compute_flow_tiled": eng.compute_flow_tiled(frames, 2, tile_size=24, tile_batch=1)[None],
        "compute_flows_tiled_stride1": eng.compute_flows_tiled_stride1(frames, tile_size=24, window_batch=2),
    }
    for name, out in outs.items():
        assert out.shape[1:] == (24, 40, 2) and np.isfinite(out).all(), name
        assert np.abs(out).max() > 0, name
    np.testing.assert_allclose(outs["compute_flows_tiled_stride1"][2], outs["compute_flow_tiled"][0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [dict(architecture="bof", sequence_length=3), dict(encoder="cnn")],
                         ids=["bof", "cnn"])
def test_get_model_info_matches_jax(cfg):
    """The architecture (BOF) and the rest of the record as the JAX engine
    reports them (tpuflow/runtime/engine.py:926-942)."""
    from tpuflow.config import ModelConfig as JaxModelConfig
    from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine

    jeng = JaxFlowEngine(JaxModelConfig(**cfg, **TINY), params={})
    jeng.load_model()
    eng = FlowEngine(ModelConfig(**cfg, **TINY), device="cpu")
    eng.load_model(allow_random_init=True)
    assert eng.get_model_info() == jeng.get_model_info()
    assert eng.get_model_info()["architecture"] == cfg.get("architecture", "mof").upper()


def test_get_memory_usage_matches_jax_on_cpu():
    from tpuflow.config import ModelConfig as JaxModelConfig
    from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine

    ref = JaxFlowEngine(JaxModelConfig(**TINY), params={}).get_memory_usage()
    assert FlowEngine(ModelConfig(**TINY), device="cpu").get_memory_usage() == ref


def test_dense_volume_bytes_counts_the_pyramid():
    from tpuflow_torch.core.corr import DenseCorrPyramid, dense_volume_bytes

    for h8, w8, levels, dtype in ((9, 11, 2, torch.float32), (13, 7, 4, torch.bfloat16)):
        f = torch.randn(2, h8, w8, 16).to(dtype)
        pyr = DenseCorrPyramid.build(f, f, levels)
        assert sum(v.numel() * v.element_size() for v in pyr.pyramid) == 2 * dense_volume_bytes(h8, w8, levels, dtype)


@pytest.mark.parametrize("impl", ["auto", "dense", "flash2", "materialized"])
def test_window_batch_clamp_matches_jax(impl, monkeypatch, capsys):
    """_clamp_window_batch against the JAX engine's for the same tile groups
    (1080p and 4K at tile_size 1280) and budgets (TPUFLOW_WB_HBM_BUDGET), the
    JAX one counting the port's volume bytes (its own count is of the TPU's
    padded layout)."""
    from tpuflow.config import ModelConfig as JaxModelConfig
    from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
    from tpuflow_torch.core.corr import dense_volume_bytes

    cfg = dict(TINY, corr_impl=impl)
    eng = FlowEngine(ModelConfig(**cfg), device="cpu")
    jeng = JaxFlowEngine(JaxModelConfig(**cfg), params={})
    monkeypatch.setattr(
        "tpuflow.core.corr.dense_volume_bytes",
        lambda h8, w8, *a, **k: dense_volume_bytes(h8, w8, eng.model.corr_levels, eng.model.corr_dtype),
    )
    clamped = 0
    for w, h in ((1920, 1080), (3840, 2160)):
        groups = eng._tiling(h, w, 1280)[1]
        per_win = max(2 * 3 * len(idxs) * dense_volume_bytes(-(-th // 8), -(-tw // 8), eng.model.corr_levels)
                      for (th, tw), idxs in groups.items())
        for budget in (1e6, per_win * 2.5, per_win * 10):
            monkeypatch.setenv("TPUFLOW_WB_HBM_BUDGET", str(budget))
            for wb in (1, 2, 4, 8):
                got = eng._clamp_window_batch(wb, 5, groups)
                assert got == jeng._clamp_window_batch(wb, 5, groups), (w, budget, wb)
                clamped += got < wb
    capsys.readouterr()
    assert (clamped > 0) == (impl != "flash2")


def test_window_batch_not_clamped_on_cpu_without_budget(monkeypatch):
    monkeypatch.delenv("TPUFLOW_WB_HBM_BUDGET", raising=False)
    eng = FlowEngine(ModelConfig(**TINY), device="cpu")
    assert eng._clamp_window_batch(64, 5, eng._tiling(2160, 3840, 1280)[1]) == 64


def test_memflow_engine_builds_and_videoflow_does_not_stream():
    """A MemFlow engine builds MemFlowNet on the CPU with the config's memory
    capacity and rope; stream_flows is MemFlow's alone, as in the JAX
    engine."""
    from tpuflow_torch.core.memflownet import MemFlowNet

    eng = FlowEngine(ModelConfig(model="memflow", memory_capacity=5, use_rope=True, **TINY), device="cpu")
    assert type(eng.model) is MemFlowNet and eng.model.memory_capacity == 5
    assert eng.model.memory_reader.use_rope
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    with pytest.raises(RuntimeError, match="load_model"):
        eng.stream_flows(frames)
    with pytest.raises(ValueError, match="MemFlow mode"):
        FlowEngine(ModelConfig(**TINY), device="cpu").stream_flows(frames)


def test_port_imports_no_jax():
    """A fresh interpreter that imports the port and runs CPU forwards through
    a VideoFlow and a MemFlow engine has neither jax nor tpuflow in
    sys.modules."""
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
        "mem = FlowEngine(ModelConfig(model='memflow', use_rope=True, decoder_depth=1, corr_levels=2, corr_radius=2), device='cpu')\n"
        "mem.load_model(allow_random_init=True)\n"
        "assert np.isfinite(mem.stream_flows(frames, warm_start=True)).all()\n"
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
