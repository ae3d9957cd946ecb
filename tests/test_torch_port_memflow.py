"""The port's MemFlow against the JAX package's on the CPU.

Weights are one random flax MemFlowNet param tree (Twins encoders, rope on),
drawn with numpy from a seed and carried into the port by
`state_dict_from_jax`; inputs are made with numpy from a seed and fed to
both sides.  Frames are 64x96 (an 8x12 feature grid) with 2 levels, radius
2, 2 iterations and a memory of 3 slots, so that 4 streamed frames wrap
the ring.  The JAX MemFlowNet materializes GMA's probabilities at every
size it can run here; the port's `attn_materialize_bytes` is lowered to
reach its K2 route (the plain version on the CPU), which agrees with the
materialized product to f32 rounding.

Tolerances: f32 module outputs 1e-5; flows 2e-3 (two iterations of
feedback through the lookup, as tests/test_memflow_parity.py); memory keys
1e-4; `valid` and `ptr` exactly.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuflow.config import MEMFLOW_STAGE_CFG as JAX_MEMFLOW_STAGE_CFG
from tpuflow.config import ModelConfig as JaxModelConfig
from tpuflow.core import gma as jgma
from tpuflow.core import memflownet as jmem
from tpuflow.core import sk as jsk
from tpuflow.core.corr import FlashCorr2 as JaxFlashCorr2
from tpuflow.runtime.convert import unflatten_params
from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
from tpuflow.runtime.windows import trailing_window_indices as jax_trailing
from tests.mirrors.memflow_torch import MemFlowNetMirror
from tests.test_torch_port_model import one_torch_thread, random_flax_params  # noqa: F401 (autouse)

from tpuflow_torch.config import MEMFLOW_STAGE_CFG, ModelConfig, memflow_stage_cfg
from tpuflow_torch.core.corr import DenseCorrPyramid, FlashCorr2
from tpuflow_torch.core.gma import Aggregate, materialize_attention
from tpuflow_torch.core.memflownet import (
    CARRY_CLAMP,
    MemFlowNet,
    MemoryReader,
    MemoryState,
    init_memory,
    memory_write,
    rope_2d,
)
from tpuflow_torch.core.sk import SKMotionEncoderMem, SKUpdateBlockMem
from tpuflow_torch.kernels.memread import memory_read, memory_read_plain, rope_table
from tpuflow_torch.runtime.convert import load_torch_state_dict, state_dict_from_jax
from tpuflow_torch.runtime.convert_memflow import MEMFLOW_IGNORE
from tpuflow_torch.runtime.engine import FlowEngine
from tpuflow_torch.runtime.windows import trailing_window_indices

CFG = dict(corr_levels=2, corr_radius=2, decoder_depth=2, memory_capacity=3)
H, W = 64, 96
H8, W8 = H // 8, W // 8
STREAM = 4                    # frames: the 3-slot ring wraps at the fourth


def rand(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def sub_params(flat, prefix):
    """The flax subtree under `prefix` ('params/.../'), for a submodule's apply."""
    return {"params": unflatten_params({p[len(prefix):]: v for p, v in flat.items() if p.startswith(prefix)})}


def np_memory(mem) -> dict:
    return {f: np.asarray(getattr(mem, f)) for f in ("keys", "values", "valid", "ptr")}


def t_memory(mem: dict) -> MemoryState:
    return MemoryState(*(torch.from_numpy(np.asarray(mem[f])) for f in ("keys", "values", "valid", "ptr")))


def assert_memory_equal(got: MemoryState, ref, what=""):
    ref = ref if isinstance(ref, dict) else np_memory(ref)
    np.testing.assert_array_equal(got.valid.numpy(), ref["valid"], err_msg=what)
    np.testing.assert_array_equal(got.ptr.numpy(), ref["ptr"], err_msg=what)
    np.testing.assert_allclose(got.keys.numpy(), ref["keys"], rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.fixture(scope="module")
def models():
    """The JAX MemFlowNet (f32, f32 volumes, plain lookups, rope on) and the
    port's on one random param tree."""
    jmodel = jmem.MemFlowNet(
        encoder="twins", use_rope=True, dtype=jnp.float32, corr_dtype=jnp.float32,
        dense_lookup="xla", **CFG,
    )
    example = (jnp.zeros((1, 2, H, W, 3)), jmodel.empty_memory(1, H, W))
    flat = random_flax_params(jmodel, seed=30, example=example)
    # The helper's flow head still moves MemFlow's flows by ~4 cells of the
    # 8x12 grid per frame, so that most taps fall off the grid; a tenth of it
    # keeps them within a cell or two and the lookups on real taps.
    for key in [k for k in flat if "/flow_head/ffn2_2/" in k]:
        flat[key] = 0.1 * flat[key]
    port = MemFlowNet(use_rope=True, corr_dtype=torch.float32, **CFG).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jmodel, unflatten_params(flat), flat, port


# ---- config and windows ----------------------------------------------------


@pytest.mark.parametrize("n,length", [(1, 2), (4, 2), (6, 5), (3, 1), (9, 3)])
def test_trailing_windows_match_jax(n, length):
    for i in range(n):
        np.testing.assert_array_equal(trailing_window_indices(n, i, length), jax_trailing(n, i, length))


@pytest.mark.parametrize("stage", ["sintel", "things", "kitti", "nope"])
def test_memflow_stage_cfg_matches_jax(stage):
    from tpuflow.config import memflow_stage_cfg as jax_memflow_stage_cfg

    assert MEMFLOW_STAGE_CFG == JAX_MEMFLOW_STAGE_CFG
    if stage == "nope":
        for fn in (memflow_stage_cfg, jax_memflow_stage_cfg):
            with pytest.raises(ValueError, match="stage"):
                fn(stage)
    else:
        assert memflow_stage_cfg(stage) == jax_memflow_stage_cfg(stage)


# ---- the memory ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 12, 64), (1, 3, 5, 16), (2, 3, 1, 7, 8)])
def test_rope_2d_matches_jax(shape):
    """Token axis h*w second to last; a leading slot axis as the keys have."""
    *lead, h, w, d = shape
    x = rand(np.random.default_rng(31), *lead, h * w, d)
    ref = np.asarray(jmem.rope_2d(jnp.asarray(x), h, w))
    got = rope_2d(torch.from_numpy(x), h, w).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # Position (0, 0) is not rotated.
    np.testing.assert_array_equal(got[..., 0, :], x[..., 0, :])


def test_rope_2d_rejects_channels_not_divisible_by_4():
    with pytest.raises(ValueError, match="divisible by 4"):
        rope_2d(torch.zeros(1, 6, 6), 2, 3)


def test_memory_write_matches_jax():
    """Six writes into a 3-slot ring of two batch rows whose pointers start
    apart (row 1 wraps after one write), with entries beyond +-CARRY_CLAMP;
    the state passed in is left as it was."""
    rng = np.random.default_rng(32)
    b, cap, hw, dk, dv = 2, 3, 10, 8, 16
    jm = jmem.init_memory(b, cap, hw, dk, dv)
    jm = jm._replace(ptr=jnp.asarray([0, 2], jnp.int32))
    tm = init_memory(b, cap, hw, dk, dv)
    tm = tm._replace(ptr=torch.tensor([0, 2]))
    for step in range(6):
        key, value = rand(rng, b, hw, dk, s=3e4), rand(rng, b, hw, dv)
        before = [t.clone() for t in tm]
        jm = jmem.memory_write(jm, jnp.asarray(key), jnp.asarray(value))
        new = memory_write(tm, torch.from_numpy(key), torch.from_numpy(value))
        for a, c in zip(before, tm):
            assert torch.equal(a, c)
        tm = new
        assert_memory_equal(tm, jm, f"write {step}")
        np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values), rtol=1e-6, atol=1e-6)
        assert tm.keys.abs().max().item() == CARRY_CLAMP
    np.testing.assert_array_equal(tm.ptr.numpy(), [6, 8])
    assert tm.valid.min().item() == 1.0


def memory_case(fill: str, rng) -> dict:
    """A 3-slot memory for two batch rows over the 8x12 grid.  Every slot
    holds random keys and values, so a slot the mask lets through changes
    the readout.  'empty': nothing valid; 'partial': row 0 one slot, row 1
    none (it reads zeros); 'full': every slot, after the pointer wrapped."""
    b, cap, hw = 2, CFG["memory_capacity"], H8 * W8
    valid = {"empty": [[0, 0, 0], [0, 0, 0]], "partial": [[0, 1, 0], [0, 0, 0]], "full": [[1, 1, 1], [1, 1, 1]]}[fill]
    return {"keys": rand(rng, b, cap, hw, 64), "values": rand(rng, b, cap, hw, 128),
            "valid": np.asarray(valid, np.float32), "ptr": np.asarray([4, 5], np.int32)}


@pytest.mark.parametrize("use_rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
def test_memory_reader_matches_jax(models, fill, use_rope):
    _, _, flat, port = models
    rng = np.random.default_rng(33)
    mem = memory_case(fill, rng)
    query = rand(rng, 2, H8, W8, 64)
    jreader = jmem.MemoryReader(128, use_rope, dtype=jnp.float32)
    params = sub_params(flat, "params/memory_reader/")
    ref = np.asarray(jreader.apply(params, jnp.asarray(query), jmem.MemoryState(*map(jnp.asarray, mem.values()))))
    reader = MemoryReader(128, use_rope).eval()
    reader.load_state_dict(port.memory_reader.state_dict())
    with torch.no_grad():
        got = reader(torch.from_numpy(query), t_memory(mem)).numpy()
    assert got.shape == (2, H8, W8, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # A row with no valid slot reads exactly zero: the output is out_proj's bias.
    bias = port.memory_reader.out_proj.bias.detach().numpy()
    for row in range(2):
        if mem["valid"][row].sum() == 0:
            np.testing.assert_array_equal(got[row], np.broadcast_to(bias, got[row].shape))


@pytest.mark.parametrize("use_rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
def test_memory_read_wrapper_matches_jax_readout(fill, use_rope):
    """K9's wrapper on CPU tensors is its plain twin, and gives the JAX
    reader's readout before out_proj (the JAX reader with an identity
    out_proj)."""
    rng = np.random.default_rng(34)
    mem = memory_case(fill, rng)
    query = rand(rng, 2, H8, W8, 64)
    jreader = jmem.MemoryReader(128, use_rope, dtype=jnp.float32)
    identity = {"params": {"out_proj": {"kernel": jnp.eye(128)[None, None], "bias": jnp.zeros(128)}}}
    ref = np.asarray(jreader.apply(identity, jnp.asarray(query), jmem.MemoryState(*map(jnp.asarray, mem.values()))))
    tm = t_memory(mem)
    table = rope_table(H8, W8, 64) if use_rope else None
    q = torch.from_numpy(query).reshape(2, H8 * W8, 64)
    got = memory_read(q, tm.keys, tm.values, tm.valid, table)
    assert torch.equal(got, memory_read_plain(q, tm.keys, tm.values, tm.valid, table))
    np.testing.assert_allclose(got.numpy().reshape(2, H8, W8, 128), ref, rtol=1e-5, atol=1e-5)


# ---- GMA with materialized probabilities -----------------------------------


@pytest.mark.parametrize("b,h,w", [(2, 9, 11), (1, 48, 64)])
def test_materialize_attention_matches_jax(b, h, w):
    """One row chunk at 99 cells, two (of 1536 rows) at 3072."""
    rng = np.random.default_rng(34)
    q, k = rand(rng, b, h, w, 128, s=128 ** -0.5), rand(rng, b, h, w, 128)
    ref = np.asarray(jgma.materialize_attention(jnp.asarray(q), jnp.asarray(k), out_dtype=jnp.float32))
    got = materialize_attention(torch.from_numpy(q), torch.from_numpy(k), torch.float32).numpy()
    assert got.shape == (b, h * w, h * w)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_aggregate_with_attn_matches_jax(models):
    """Aggregate(attn=) against the JAX Aggregate on the same probabilities,
    and against its own K2 route (the plain version here) without them."""
    _, _, flat, port = models
    rng = np.random.default_rng(35)
    q, k = rand(rng, 1, H8, W8, 128, s=128 ** -0.5), rand(rng, 1, H8, W8, 128)
    fmap = rand(rng, 1, H8, W8, 128)
    attn = jgma.materialize_attention(jnp.asarray(q), jnp.asarray(k), out_dtype=jnp.float32)
    jagg = jgma.Aggregate(dtype=jnp.float32, impl="xla")
    ref = np.asarray(jagg.apply(sub_params(flat, "params/iteration/update_block/aggregator/"),
                                jnp.asarray(q), jnp.asarray(k), jnp.asarray(fmap), attn))
    agg = Aggregate(128).eval()
    agg.load_state_dict(port.update_block.aggregator.state_dict())
    tq, tk, tf = map(torch.from_numpy, (q, k, fmap))
    with torch.no_grad():
        got = agg(tq, tk, tf, torch.from_numpy(np.array(attn))).numpy()
        flash = agg(tq, tk, tf).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flash, got, rtol=1e-5, atol=1e-5)


# ---- the update block ------------------------------------------------------


def update_inputs(rng):
    planes = CFG["corr_levels"] * (2 * CFG["corr_radius"] + 1) ** 2
    return dict(
        net=np.tanh(rand(rng, 1, H8, W8, 128)), inp=np.maximum(rand(rng, 1, H8, W8, 128), 0),
        corr=rand(rng, 1, H8, W8, planes), flow=rand(rng, 1, H8, W8, 2, s=3.0),
        q=rand(rng, 1, H8, W8, 128, s=128 ** -0.5), k=rand(rng, 1, H8, W8, 128),
        mem_read=rand(rng, 1, H8, W8, 128),
    )


def test_sk_motion_encoder_mem_matches_jax(models):
    _, _, flat, port = models
    x = update_inputs(np.random.default_rng(36))
    jenc = jsk.SKMotionEncoderMem(dtype=jnp.float32)
    ref = np.asarray(jenc.apply(sub_params(flat, "params/iteration/update_block/encoder/"),
                                *(jnp.asarray(x[n]) for n in ("flow", "corr", "mem_read"))))
    enc = SKMotionEncoderMem(CFG["corr_levels"], CFG["corr_radius"], (1, 15)).eval()
    enc.load_state_dict(port.update_block.encoder.state_dict(), strict=True)
    with torch.no_grad():
        got = enc(*(torch.from_numpy(x[n]) for n in ("flow", "corr", "mem_read"))).numpy()
    assert got.shape == (1, H8, W8, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_attn", [True, False], ids=["materialized", "k2"])
def test_sk_update_block_mem_matches_jax(models, with_attn):
    """One step (motion encoder with the readout, GMA, 'gru', flow head, mask
    head).  The JAX block gets the probabilities; the port's gets them, or
    runs K2's route without them."""
    _, _, flat, port = models
    x = update_inputs(np.random.default_rng(37))
    names = ("net", "inp", "corr", "flow", "q", "k", "mem_read")
    attn = jgma.materialize_attention(jnp.asarray(x["q"]), jnp.asarray(x["k"]), out_dtype=jnp.float32)
    jblock = jsk.SKUpdateBlockMem(hidden_dim=128, dtype=jnp.float32, gma_impl="xla")
    jout = jblock.apply(sub_params(flat, "params/iteration/update_block/"),
                        *(jnp.asarray(x[n]) for n in names), attn)
    block = SKUpdateBlockMem(CFG["corr_levels"], CFG["corr_radius"]).eval()
    block.load_state_dict(port.update_block.state_dict(), strict=True)
    with torch.no_grad():
        tout = block(*(torch.from_numpy(x[n]) for n in names),
                     torch.from_numpy(np.array(attn)) if with_attn else None)
    for name, j, t in zip(("net", "motion", "mask", "delta"), jout, tout):
        assert tuple(t.shape) == j.shape, name
        # f32 both sides: five PCBlocks of 15x15 depthwise convs, summed in
        # another order (as the MOF block's test).
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=name)


# ---- weights ---------------------------------------------------------------


def test_conversion_is_total(models):
    """state_dict_from_jax fills every port parameter and nothing else."""
    _, _, flat, port = models
    sd = state_dict_from_jax(flat)
    assert len(sd) == len(flat)
    ref = port.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
    assert {"qk_proj.weight", "v_proj.bias", "memory_reader.out_proj.weight",
            "update_block.mask.2.weight", "update_block.encoder.convf1_.weight"} <= set(sd)


def test_mirror_state_dict_loads_strict():
    """The upstream-named mirror's state dict is the port's."""
    mirror = MemFlowNetMirror(**CFG).state_dict()
    port = MemFlowNet(**CFG)
    port.load_state_dict(mirror, strict=True)
    assert set(mirror) == set(port.state_dict())


def test_memflow_pth_loads_with_its_ignore_table(tmp_path):
    """A DataParallel MemFlow .pth: `module.` goes, MEMFLOW_IGNORE keys are
    dropped, and the engine loads the rest strictly."""
    cfg = ModelConfig(model="memflow", use_rope=True, **CFG)
    ckpt = {f"module.{k}": v for k, v in MemFlowNet(use_rope=True, **CFG).state_dict().items()}
    ckpt["module.cnet.svt.blocks.3.0.attn.q.weight"] = torch.zeros(3)
    ckpt["module.update_block.aggregator.pos_emb.rel_width.weight"] = torch.zeros(3)
    path = tmp_path / "MemFlowNet_sintel.pth"
    torch.save({"state_dict": ckpt}, path)
    sd = load_torch_state_dict(str(path), MEMFLOW_IGNORE)
    assert not any(re.search(p, k) for k in sd for p in MEMFLOW_IGNORE)
    eng = FlowEngine(cfg, device="cpu")
    assert eng.load_model(str(path)) == str(path)
    torch.testing.assert_close(eng.model.qk_proj.weight, ckpt["module.qk_proj.weight"])


# ---- the whole net, streamed -----------------------------------------------


def jax_flash2_corr_state(corr):
    """The arrays of a JAX FlashCorr2 as MemFlowNet's scan carries them.  The
    reference's `_corr_state` reads `corr.pyramid`, which FlashCorr2 does not
    have (it holds `packed_pyr`), so its MemFlowNet cannot build FlashCorr2
    at all; `_corr_from_state` already rebuilds one from (fmap1, packed_pyr)."""
    if isinstance(corr, JaxFlashCorr2):
        return corr.fmap1, tuple(corr.packed_pyr)
    return ORIG_CORR_STATE(corr)


ORIG_CORR_STATE = jmem._corr_state


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX model streamed over STREAM frames (pair (max(i-1, 0), i),
    memory carried) with the dense pyramid and with FlashCorr2 (its Pallas
    kernel in interpret mode): per frame the flow, the 1/8 flow and the
    memory after it."""
    jmodel, params, _, _ = models
    frames = np.random.default_rng(38).random((STREAM, H, W, 3), np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmem, "_corr_state", jax_flash2_corr_state)
        for corr in ("dense", "flash2"):
            apply = jax.jit(jmodel.clone(corr_impl=corr).apply)
            mem, steps = jmodel.empty_memory(1, H, W), []
            for i in range(STREAM):
                flow, mem, low = apply(params, jnp.asarray(frames[[max(i - 1, 0), i]][None]), mem)
                steps.append((np.asarray(flow), np.asarray(low), np_memory(mem)))
            out[corr] = steps
    return frames, out


@pytest.mark.parametrize("gma", ["materialized", "k2"])
@pytest.mark.parametrize("corr", ["dense", "flash2"])
def test_memflownet_stream_matches_jax(models, jax_streams, corr, gma):
    """The port's MemFlowNet streamed as the JAX one, frame by frame: flows,
    1/8 flows and the memory (keys, valid, ptr) after each frame, through
    the wrap past capacity.  'flash2' lowers the port's materialization
    threshold so that 'auto' builds FlashCorr2 (K3's route); 'k2' lowers the
    GMA gate so that every iteration takes K2's route."""
    _, _, flat, _ = models
    frames, ref = jax_streams
    port = MemFlowNet(use_rope=True, corr_dtype=torch.float32, **CFG).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    if corr == "flash2":
        port.materialize_threshold = 0
    if gma == "k2":
        port.attn_materialize_bytes = 0
    mem = port.empty_memory(1, H, W)
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(frames[:2][None]))
        assert isinstance(enc.corr, FlashCorr2 if corr == "flash2" else DenseCorrPyramid)
        assert (enc.attn is None) == (gma == "k2")
        for i, (jflow, jlow, jmem_i) in enumerate(ref[corr]):
            flow, mem, low = port(torch.from_numpy(frames[[max(i - 1, 0), i]][None]), mem)
            assert tuple(flow.shape) == (1, H, W, 2) and tuple(low.shape) == (1, H8, W8, 2)
            np.testing.assert_allclose(flow.numpy(), jflow, rtol=2e-3, atol=2e-3, err_msg=f"frame {i}")
            np.testing.assert_allclose(low.numpy(), jlow, rtol=2e-3, atol=2e-3, err_msg=f"frame {i}")
            assert_memory_equal(mem, jmem_i, f"frame {i}")
    assert mem.ptr.item() == STREAM and mem.valid.min().item() == 1.0


# ---- the engine ------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(models):
    """The JAX and the port's MemFlow FlowEngine on the same weights (f32
    volumes), and a clip of uint8 62x94 frames (edge-padded to 64x96)."""
    _, params, flat, _ = models
    cfg = dict(model="memflow", use_rope=True, **CFG)
    jeng = JaxFlowEngine(JaxModelConfig(**cfg), params=params, dtype=jnp.float32)
    jeng.model = jeng.model.clone(corr_dtype=jnp.float32)
    jeng.load_model()
    eng = FlowEngine(ModelConfig(**cfg), params=state_dict_from_jax(flat), device="cpu")
    eng.model.corr_dtype = torch.float32
    assert eng.load_model() == "preloaded"
    frames = (np.random.default_rng(39).random((STREAM + 1, H - 2, W - 2, 3)) * 255).astype(np.uint8)
    return frames, jeng, eng


@pytest.mark.parametrize("warm_start", [False, True], ids=["cold", "warm"])
def test_stream_flows_matches_jax(engines, warm_start):
    frames, jeng, eng = engines
    got = eng.stream_flows(frames, warm_start=warm_start)
    assert got.shape == (STREAM + 1, H - 2, W - 2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jeng.stream_flows(frames, warm_start=warm_start), rtol=2e-3, atol=2e-3)
    assert eng.memory.ptr.item() == STREAM + 1 and eng.memory.valid.min().item() == 1.0


def test_compute_flow_matches_jax(engines):
    """compute_flow and compute_flow_batch: each index's last two frames on
    an empty memory; frame 0 pairs with itself, as stream_flows's frame 0
    does, bit for bit."""
    frames, jeng, eng = engines
    got = eng.compute_flow_batch(frames, [0, 3])
    assert got.shape == (2, H - 2, W - 2, 2)
    np.testing.assert_allclose(got, jeng.compute_flow_batch(frames, [0, 3]), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(eng.compute_flow(frames, 3), got[1])
    np.testing.assert_array_equal(got[0], eng.stream_flows(frames[:2])[0])
    # Later frames read the memory, which compute_flow starts empty.
    assert not np.array_equal(got[1], eng.stream_flows(frames)[3])


def test_tile_entries_route_to_compute_flow(engines):
    """MemFlow never tiles (tpuflow/runtime/engine.py:482-485, 686-693): both
    tile entries give compute_flow's flows, even where the frame is larger
    than a tile."""
    frames, _, eng = engines
    np.testing.assert_array_equal(eng.compute_flow_tiled(frames, 2, tile_size=32), eng.compute_flow(frames, 2))
    stride1 = eng.compute_flows_tiled_stride1(frames[:3], tile_size=32, window_batch=2)
    for i in range(3):
        np.testing.assert_array_equal(stride1[i], eng.compute_flow(frames[:3], i))


def test_memflow_engine_refuses_videoflow_modes(engines):
    _, jeng, eng = engines
    with pytest.raises(ValueError, match="VideoFlow mode"):
        eng.compute_flows_strided(np.zeros((3, 16, 16, 3), np.uint8))
    assert eng.get_model_info() == jeng.get_model_info()
    assert eng.get_memory_usage() == jeng.get_memory_usage()
