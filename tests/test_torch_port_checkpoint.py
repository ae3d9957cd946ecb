"""The port's native checkpoints (tpuflow_torch.runtime.checkpoint) against
the JAX package's (tpuflow.runtime.checkpoint) on the CPU, both ways, for
MOFNet, BOFNet and MemFlowNet param trees drawn with numpy from a seed.

The port writes the JAX package's file byte for byte (the flax tree in
float32, maps in sorted key order, the same msgpack encodings), and reads
it into the state dict `state_dict_from_jax` gives, exactly.
"""

import os

import msgpack
import numpy as np
import pytest
import torch

import flax.serialization as flax_serialization
import jax.numpy as jnp

from tpuflow.core import memflownet as jmem
from tpuflow.core.mofnet import BOFNet as JaxBOFNet
from tpuflow.core.mofnet import MOFNet as JaxMOFNet
from tpuflow.runtime import checkpoint as jcheckpoint
from tpuflow.runtime.convert import flatten_params, unflatten_params
from tests.test_torch_port_model import CFG, one_torch_thread, random_flax_params  # noqa: F401 (autouse)

from tpuflow_torch.config import ModelConfig
from tpuflow_torch.core.memflownet import MemFlowNet
from tpuflow_torch.core.mofnet import BOFNet, MOFNet
from tpuflow_torch.runtime import checkpoint
from tpuflow_torch.runtime.convert import flax_tree_from_state_dict, state_dict_from_jax
from tpuflow_torch.runtime.engine import FlowEngine, init_random_

MEM_CFG = dict(CFG, memory_capacity=3)


def trees():
    """{name: (flat flax tree, the port's model)} of MOF, BOF and MemFlow."""
    jmof = JaxMOFNet(encoder="twins", dtype=jnp.float32, **CFG)
    jbof = JaxBOFNet(encoder="twins", dtype=jnp.float32, **CFG)
    jmm = jmem.MemFlowNet(encoder="twins", use_rope=True, dtype=jnp.float32, **MEM_CFG)
    example = (jnp.zeros((1, 2, 64, 96, 3)), jmm.empty_memory(1, 64, 96))
    return {
        "mof": (random_flax_params(jmof, seed=50), MOFNet(**CFG)),
        "bof": (random_flax_params(jbof, seed=51), BOFNet(**CFG)),
        "memflow": (random_flax_params(jmm, seed=52, example=example), MemFlowNet(use_rope=True, **MEM_CFG)),
    }


@pytest.fixture(scope="module")
def models():
    return trees()


@pytest.mark.parametrize("name", ["mof", "bof", "memflow"])
def test_jax_file_loads_in_the_port(models, name, tmp_path):
    """A file from the JAX package's save_params loads in the port equal to
    state_dict_from_jax, bit for bit, and fits the port's model."""
    flat, model = models[name]
    path = str(tmp_path / f"{name}.msgpack")
    jcheckpoint.save_params(path, unflatten_params(flat))
    got = checkpoint.load_params(path, model.state_dict())
    ref = state_dict_from_jax(flat)
    assert set(got) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["mof", "bof", "memflow"])
def test_port_file_loads_in_jax(models, name, tmp_path):
    """The port's save_params of a state dict (in bf16, as an engine on the
    card holds it, and in f32) writes the JAX package's bytes for the same
    tree, and the JAX package's load_params reads it equal to the tree."""
    flat, _ = models[name]
    state = state_dict_from_jax(flat)
    path, jpath = str(tmp_path / "port.tpuflow"), str(tmp_path / "jax.msgpack")
    checkpoint.save_params(path, state)
    jcheckpoint.save_params(jpath, unflatten_params(flat))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    target = unflatten_params({k: np.zeros_like(v) for k, v in flat.items()})
    back = flatten_params(jcheckpoint.load_params(path, target))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    # A bf16 state dict is written in f32, and reads back as its bf16 values.
    bf16 = {k: v.to(torch.bfloat16) for k, v in state.items()}
    checkpoint.save_params(path, bf16)
    for k, v in checkpoint.load_params(path).items():
        assert v.dtype == torch.float32 and torch.equal(v, bf16[k].float()), k


def test_tree_conversion_is_the_inverse(models):
    for flat, _ in models.values():
        tree = flax_tree_from_state_dict(state_dict_from_jax(flat))
        back = flatten_params(tree)
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="no flax name"):
        flax_tree_from_state_dict({"fnet.svt.blocks.0.weight": torch.zeros(2, 2)})


def test_bad_magic_and_misfit_raise(models, tmp_path):
    flat, model = models["mof"]
    path = str(tmp_path / "bad.msgpack")
    with open(path, "wb") as f:
        f.write(b"not-a-checkpoint" + msgpack.packb({"params": {}}))
    with pytest.raises(ValueError, match="not a tpuflow native checkpoint"):
        checkpoint.load_params(path)
    with pytest.raises(ValueError, match="not a tpuflow native checkpoint"):
        jcheckpoint.load_params(path, {})
    checkpoint.save_params(path, state_dict_from_jax(flat))
    with pytest.raises(ValueError, match="does not fit the model"):
        checkpoint.load_params(path, models["bof"][1].state_dict() | {"extra.weight": torch.zeros(1)})


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -2**15 - 1, -2**40,
    1.5, "x" * 31, "é" * 40, b"y" * 300, True, False, None, list(range(20)), [1, "a", b"b"],
], ids=lambda v: type(v).__name__)
def test_codec_matches_msgpack(value):
    assert checkpoint.packb(value) == msgpack.packb(value)
    assert checkpoint.unpackb(msgpack.packb(value)) == value


def test_codec_arrays_and_chunks_match_flax(monkeypatch):
    """Arrays (f32, int64, empty, a numpy scalar, bf16 by name) and leaves
    above the chunk limit (lowered on both sides to 1000 bytes) are written
    as flax writes them and read back."""
    rng = np.random.default_rng(0)
    half = rng.standard_normal((2, 3)).astype(np.float32)
    tree = {"params": {"b": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(np.float32),
                             "bias": np.zeros(5, np.float32)},
                       "s": {"n": np.float32(3.0), "i": np.arange(300)},
                       "h": np.asarray(jnp.asarray(half, jnp.bfloat16)),
                       "big": rng.standard_normal(2500).astype(np.float32), "e": np.zeros((0, 2), np.float32)}}
    port_tree = {"params": dict(tree["params"], h=torch.from_numpy(half).to(torch.bfloat16))}
    for limit in (2**30, 1000):
        monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", limit)
        monkeypatch.setattr(checkpoint, "MAX_CHUNK_BYTES", limit)
        blob = checkpoint.packb(checkpoint._chunk_leaves(port_tree))
        assert blob == flax_serialization.msgpack_serialize(tree)
        back = checkpoint._unchunk_leaves(checkpoint.unpackb(blob))["params"]
        np.testing.assert_array_equal(back["big"], tree["params"]["big"])
        assert back["s"]["n"] == np.float32(3.0) and back["e"].shape == (0, 2)
        assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"], port_tree["params"]["h"])
        restored = flax_serialization.msgpack_restore(blob)["params"]
        assert restored["h"].dtype == jnp.bfloat16


def test_load_model_routes_by_suffix(tmp_path):
    """FlowEngine.load_model reads .msgpack and .tpuflow files as native
    checkpoints and anything else as a torch .pth (with `module.` prefixes),
    as the JAX engine routes them."""
    cfg = ModelConfig(encoder="cnn", **CFG)
    src = FlowEngine(cfg, device="cpu", seed=9)
    src.load_model(allow_random_init=True)
    state = src.model.state_dict()
    paths = {"native": str(tmp_path / "w.msgpack"), "tpuflow": str(tmp_path / "w.TPUFLOW"),
             "pth": str(tmp_path / "w.pth")}
    checkpoint.save_params(paths["native"], state)
    checkpoint.save_params(paths["tpuflow"], state)
    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()}}, paths["pth"])
    assert checkpoint.is_native_checkpoint(paths["native"]) and checkpoint.is_native_checkpoint(paths["tpuflow"])
    assert not checkpoint.is_native_checkpoint(paths["pth"])
    assert jcheckpoint.is_native_checkpoint(paths["tpuflow"])
    for path in paths.values():
        eng = FlowEngine(cfg, device="cpu", seed=1)
        assert eng.load_model(path) == path
        for k, v in eng.model.state_dict().items():
            assert torch.equal(v, state[k]), (path, k)
    with pytest.raises(ValueError, match="not a tpuflow native checkpoint"):
        with open(paths["native"], "wb") as f:
            f.write(b"junk")
        FlowEngine(cfg, device="cpu").load_model(paths["native"])


def test_main_converts_a_pth(tmp_path, capsys):
    """`python3 -m tpuflow_torch.runtime.checkpoint IN.pth OUT.msgpack
    --device cpu` at the full MOF widths (cnn) and for MemFlow: the native
    file holds the .pth's f32 weights and reads in the JAX package too; a
    destination without a native suffix is refused."""
    for model, extra in (("videoflow", ["--encoder", "cnn"]), ("memflow", [])):
        cfg = ModelConfig(model=model, encoder="cnn" if extra else "twins", use_rope=model == "memflow")
        eng = FlowEngine(cfg, device="cpu", dtype=torch.float32)
        init_random_(eng.model, 4)
        state = eng.model.state_dict()
        pth, dst = str(tmp_path / f"{model}.pth"), str(tmp_path / f"{model}.msgpack")
        torch.save(state, pth)
        assert checkpoint.main([pth, dst, "--model", model, "--device", "cpu", *extra]) == 0
        assert f"converted {pth} -> {dst}" in capsys.readouterr().out
        got = checkpoint.load_params(dst, state)
        for k, v in state.items():
            assert torch.equal(got[k], v), k
        with open(dst, "rb") as f:
            assert f.read().startswith(jcheckpoint._MAGIC)
    with pytest.raises(SystemExit):
        checkpoint.main([pth, str(tmp_path / "out.pth"), "--device", "cpu"])
    assert not os.path.exists(str(tmp_path / "out.pth"))
