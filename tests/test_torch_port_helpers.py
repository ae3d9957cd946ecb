"""The port's small public helpers against their JAX originals, and the
engine's random-init sentinels, on the CPU.

Integer and copy helpers are held equal; the bilinear upsample within 1e-5
(f32 interpolation weights computed in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuflow.config import ModelConfig as JaxModelConfig
from tpuflow.core import padding as jpadding
from tpuflow.core.update import upsample_flow_bilinear as jax_upsample_flow_bilinear
from tpuflow.runtime import convert as jconvert
from tpuflow.runtime import tiles as jtiles
from tpuflow.runtime import windows as jwindows
from tpuflow.runtime.device import DeviceManager as JaxDeviceManager
from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

from tpuflow_torch.config import ModelConfig
from tpuflow_torch.core.padding import InputPadder, bucket_shape
from tpuflow_torch.core.update import upsample_flow_bilinear
from tpuflow_torch.runtime import convert, tiles, windows
from tpuflow_torch.runtime.convert import state_dict_from_jax
from tpuflow_torch.runtime.device import DeviceManager
from tpuflow_torch.runtime.engine import BENCH_RANDOM_INIT, RANDOM_INIT, FlowEngine

SMALL = dict(decoder_depth=1, corr_levels=2, corr_radius=2, feature_dim=64, hidden_dim=32, context_dim=32)


def small_cfg(cls):
    cfg = cls(encoder="cnn", sequence_length=3)
    for k, v in SMALL.items():
        object.__setattr__(cfg, k, v)
    return cfg


@pytest.mark.parametrize("dims,multiple,mode", [
    ((2, 3, 37, 50), 8, "sintel"), ((37, 50), 8, "kitti"), ((1, 64, 48), 8, "sintel"), ((5, 2, 9, 13), 16, "other"),
])
def test_input_padder_matches_jax(dims, multiple, mode):
    x = np.random.default_rng(1).random(dims).astype(np.float32)
    jp, tp = jpadding.InputPadder(dims, multiple, mode), InputPadder(dims, multiple, mode)
    assert tp.padded_shape == jp.padded_shape
    ref = np.asarray(jp.pad(jnp.asarray(x)))
    got = tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)
    a, b = tp.pad(torch.from_numpy(x), torch.from_numpy(2 * x))
    ja, jb = jp.pad(jnp.asarray(x), jnp.asarray(2 * x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("hw,quantum", [((1080, 1920), 64), ((64, 64), 64), ((1, 65), 64), ((481, 641), 32)])
def test_bucket_shape_matches_jax(hw, quantum):
    assert bucket_shape(*hw, quantum) == jpadding.bucket_shape(*hw, quantum)


@pytest.mark.parametrize("factor", [8, 4])
def test_upsample_flow_bilinear_matches_jax(factor):
    flow = np.random.default_rng(2).normal(0, 5, (2, 5, 7, 2)).astype(np.float32)
    ref = np.asarray(jax_upsample_flow_bilinear(jnp.asarray(flow), factor))
    got = upsample_flow_bilinear(torch.from_numpy(flow), factor)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["centered", "trailing"])
@pytest.mark.parametrize("n,length", [(1, 5), (7, 5), (10, 3), (4, 2)])
def test_all_window_indices_matches_jax(n, length, kind):
    got = windows.all_window_indices(n, length, kind)
    np.testing.assert_array_equal(got, jwindows.all_window_indices(n, length, kind))
    assert got.dtype == np.int32


def test_tile_info_matches_jax():
    assert [f.name for f in dataclasses.fields(tiles.TileInfo)] == [f.name for f in dataclasses.fields(jtiles.TileInfo)]
    assert dataclasses.asdict(tiles.TileInfo(1, 2, 3, 4, 5, 6)) == dataclasses.asdict(jtiles.TileInfo(1, 2, 3, 4, 5, 6))


@pytest.mark.parametrize("overlap", [0, 8])
@pytest.mark.parametrize("hw,tile", [((40, 96), 48), ((64, 64), 32)])
def test_extract_tile_batch_matches_jax(hw, tile, overlap):
    frames = np.random.default_rng(3).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    grid = jtiles.calculate_tile_grid(hw[1], hw[0], tile)
    assert tiles.calculate_tile_grid(hw[1], hw[0], tile) == grid
    info = grid[-1]
    got = tiles.extract_tile_batch(frames, info, tile, overlap)
    np.testing.assert_array_equal(got, jtiles.extract_tile_batch(frames, info, tile, overlap))


def test_device_manager_devices(monkeypatch):
    """On the CPU both list CPU devices (JAX its 8 virtual ones, the port
    the one torch.device); with cards the port lists cuda:0..n-1 for every
    platform but 'cpu'."""
    assert {d.platform for d in JaxDeviceManager.devices()} == {"cpu"}
    assert DeviceManager.devices() == [torch.device("cpu")] == DeviceManager.devices("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert DeviceManager.devices() == cards == DeviceManager.devices("auto") == DeviceManager.devices("cuda")
    assert DeviceManager.devices("cpu") == [torch.device("cpu")]


@pytest.fixture(scope="module")
def random_engines():
    """Port engines (cnn, narrow) loaded through each random-init route."""
    out = {}
    for name, kw in (("bench", dict(checkpoint_path=BENCH_RANDOM_INIT)),
                     ("sentinel", dict(checkpoint_path=RANDOM_INIT)),
                     ("allow", dict(allow_random_init=True))):
        eng = FlowEngine(small_cfg(ModelConfig), device="cpu", seed=4)
        eng.load_model(**kw)
        out[name] = eng
    return out


def test_random_init_sentinels_give_one_set_of_weights(random_engines):
    """'__bench_random_init__' (bench.py's and the JAX benchmarks'), the
    RANDOM_INIT sentinel and allow_random_init=True load the same seeded
    weights, as tpuflow/runtime/engine.py:148-149 routes both sentinels."""
    ref = random_engines["allow"].model.state_dict()
    for name in ("bench", "sentinel"):
        sd = random_engines[name].model.state_dict()
        assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in ref), name
        assert random_engines[name].is_model_loaded()


def test_init_params_matches_the_loaded_weights_and_jax_tree(random_engines):
    """init_params returns load_model's random weights without loading
    them, under the names and shapes of the JAX package's init_params tree."""
    eng = random_engines["allow"]
    fresh = FlowEngine(small_cfg(ModelConfig), device="cpu", seed=4)
    params = fresh.init_params()
    assert not fresh.is_model_loaded()
    ref = eng.model.state_dict()
    assert params.keys() == ref.keys() and all(torch.equal(params[k], ref[k]) for k in ref)
    jtree = JaxFlowEngine(small_cfg(JaxModelConfig), device=jax.devices("cpu")[0], seed=4).init_params()
    flat = jconvert.flatten_params(jtree)
    shapes = {k: tuple(v.shape) for k, v in state_dict_from_jax(flat).items()}
    assert shapes == {k: tuple(v.shape) for k, v in params.items()}


def test_describe_state_dict_matches_jax(random_engines):
    sd = {k: v.numpy() for k, v in random_engines["allow"].model.state_dict().items()}
    for rows in (0, 2):
        assert convert.describe_state_dict(sd, rows) == jconvert.describe_state_dict(sd, rows)
    assert convert.describe_state_dict(random_engines["allow"].model.state_dict()) == \
        jconvert.describe_state_dict(sd)


def test_suggest_mapping_matches_jax(random_engines):
    """The port's proposal maps a checkpoint onto the port's own names; the
    JAX package's maps it onto flax paths.  On a checkpoint whose names
    lost their module prefixes, both propose the same tensor for every
    name (the JAX path written back as a port name), but for the learned
    hidden-state init: its flax leaf is channels-last [48], which the JAX
    proposal cannot match to the checkpoint's [1, 1, 48, 1, 1], while the
    port keeps the checkpoint's layout.  A shape the model lacks maps to
    None on both."""
    model_sd = random_engines["allow"].model.state_dict()
    ckpt = {k.split(".", 1)[1] + f".t{i}": v.numpy() for i, (k, v) in enumerate(model_sd.items())}
    ckpt["extra.weight"] = np.zeros((3, 5, 7, 9), np.float32)
    got = convert.suggest_mapping(ckpt, model_sd)
    assert got["extra.weight"] is None
    assert sum(v is None for v in got.values()) == 1
    assert len({v for v in got.values() if v}) == len(got) - 1
    assert all(tuple(model_sd[v].shape) == tuple(ckpt[k].shape) for k, v in got.items() if v)
    from tpuflow_torch.runtime.convert import flax_tree_from_state_dict, torch_key_from_flax

    jparams = flax_tree_from_state_dict(model_sd)
    jgot = jconvert.suggest_mapping(ckpt, jparams)
    hidden = next(k for k in ckpt if "init_hidden_state" in k)
    assert jgot.pop(hidden) is None and got.pop(hidden) == "update_block.encoder.init_hidden_state"
    assert {k: v and torch_key_from_flax(v) for k, v in jgot.items()} == got
