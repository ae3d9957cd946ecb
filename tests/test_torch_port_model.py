"""The port's model modules against the JAX reference on the CPU.

Weights are one random flax MOFNet param tree, drawn with numpy from a
seed, carried into the port by `state_dict_from_jax`.  Inputs are made with
numpy from a seed and fed to both sides.  Frames are 72x88: H/4 = 18 and
W/4 = 22 are not multiples of sr=8, so the GSA sub-sample's SAME padding
is exercised, and the 9x11 feature grid (hw = 99) exercises ragged tails.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuflow.core.encoders import ResidualBlock as JaxResidualBlock
from tpuflow.core.mofnet import BOFNet as JaxBOFNet
from tpuflow.core.mofnet import MOFNet as JaxMOFNet
from tpuflow.core.sk import SKUpdateBlockMOF as JaxSKUpdateBlockMOF
from tpuflow.core.update import upsample_flow_convex as jax_upsample_flow_convex
from tpuflow.runtime.convert import unflatten_params
from tests.jax_learned_start import jax_learned_start  # noqa: F401 (autouse)
from tests.mirrors.mof_torch import MOFNetMirror

from tpuflow_torch.core.encoders import BasicEncoder, ResidualBlock
from tpuflow_torch.core.mofnet import BOFNet, MOFNet
from tpuflow_torch.core.sk import SKUpdateBlockMOF
from tpuflow_torch.core.update import upsample_flow_convex
from tpuflow_torch.runtime.convert import (
    VIDEOFLOW_IGNORE,
    load_torch_state_dict,
    state_dict_from_jax,
    torch_key_from_flax,
)

CFG = dict(corr_levels=2, corr_radius=2, decoder_depth=2)
H, W = 72, 88


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in each port test module (imported by
    the others): the suite's workers share the machine's cores, and a
    thread per core in each worker oversubscribes them many times over at
    these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_flax_params(model, seed: int, h: int = H, w: int = W, example=None):
    """A flat flax param tree for `model` ('params/...' paths), drawn with
    numpy: kernels N(0, 1/fan_in), biases, LayerNorm and GroupNorm scales
    and GMA's gamma off their constant inits so that a misrouted leaf shows
    in the outputs.  The tree's shapes come from jax.eval_shape, which traces
    the init (on `example`, default a 3-frame window, or on a tuple of
    arguments) without compiling it.
    The flow head's output conv is scaled down so that flows stay within a
    few pixels and the lookups read real taps."""
    if example is None:
        example = jnp.zeros((1, 3, h, w, 3))
    args = example if isinstance(example, tuple) else (example,)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(p.key) for p in path)
        shape = leaf.shape
        kind = key.rsplit("/", 1)[-1]
        if kind == "kernel":
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif kind == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "gamma":
            val = 0.5 + 0.1 * rng.standard_normal(shape)
        else:                                   # bias, init_hidden_state
            val = 0.1 * rng.standard_normal(shape)
        if "/flow_head/ffn2_2/" in key:
            val = 0.05 * val
        flat[key] = val.astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMOFNet(
        encoder="twins", dtype=jnp.float32, corr_dtype=jnp.float32,
        dense_lookup="xla", gma_impl="xla", **CFG,
    )
    flat = random_flax_params(jmodel, seed=0)
    port = MOFNet(corr_dtype=torch.float32, **CFG).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jmodel, unflatten_params(flat), flat, port


def test_conversion_is_total(models):
    _, _, flat, port = models
    sd = state_dict_from_jax(flat)
    assert len(sd) == len(flat)                 # no two flax leaves collide
    ref = port.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k


def test_names_and_shapes_match_upstream():
    """The port's state dict is the upstream one (as the independent mirror
    writes it), so a real VideoFlow .pth loads with strict=True."""
    mirror = MOFNetMirror(**CFG).state_dict()
    port = MOFNet(**CFG).state_dict()
    assert set(mirror) == set(port)
    for k, v in mirror.items():
        assert tuple(v.shape) == tuple(port[k].shape), k


@pytest.mark.parametrize(
    "flax_path,torch_key",
    [
        ("params/fnet/blocks_0_1/attn/kv/kernel", "fnet.svt.blocks.0.1.attn.kv.weight"),
        ("params/cnet/patch_embeds_1/norm/scale", "cnet.svt.patch_embeds.1.norm.weight"),
        ("params/fnet/pos_block_0/proj_0/bias", "fnet.svt.pos_block.0.proj.0.bias"),
        ("params/att/to_qk/kernel", "att.to_qk.weight"),
        ("params/iteration/update_block/encoder/convc1/conv_list_1/kernel",
         "update_block.encoder.convc1.conv_list.1.weight"),
        ("params/iteration/update_block/gru/ffn2_2/bias", "update_block.gru.ffn2.2.bias"),
        ("params/iteration/update_block/mask_0/kernel", "update_block.mask.0.weight"),
        ("params/iteration/update_block/aggregator/gamma", "update_block.aggregator.gamma"),
        ("params/iteration/update_block/encoder/init_hidden_state",
         "update_block.encoder.init_hidden_state"),
        ("params/fnet/conv1/kernel", "fnet.conv1.weight"),
        ("params/fnet/norm1/scale", "fnet.norm1.weight"),
        ("params/cnet/layer2_0/downsample/kernel", "cnet.layer2.0.downsample.weight"),
        ("params/cnet/layer3_1/norm2/bias", "cnet.layer3.1.norm2.bias"),
    ],
)
def test_flax_key_rewrite(flax_path, torch_key):
    assert torch_key_from_flax(flax_path) == torch_key


def test_load_torch_state_dict_strips_and_ignores(tmp_path):
    """A DataParallel .pth: `module.` goes, VIDEOFLOW_IGNORE keys are
    dropped, and the rest loads strictly."""
    port = MOFNet(**CFG)
    ckpt = {f"module.{k}": v for k, v in port.state_dict().items()}
    ckpt["module.fnet.svt.blocks.2.0.attn.q.weight"] = torch.zeros(3)
    ckpt["module.att.pos_emb.rel_height.weight"] = torch.zeros(3)
    path = tmp_path / "MOF_sintel.pth"
    torch.save({"state_dict": ckpt}, path)
    sd = load_torch_state_dict(str(path))
    assert not any(re.search(p, k) for k in sd for p in VIDEOFLOW_IGNORE)
    MOFNet(**CFG).load_state_dict(sd, strict=True)


def test_twins_frame_features_match_flax(models):
    """fnet and cnet (TwinsSVT) through frame_features."""
    jmodel, params, _, port = models
    frames = np.random.default_rng(1).random((2, H, W, 3), np.float32)
    jf, jc = jax.jit(lambda p, x: jmodel.apply(p, x, method="frame_features"))(
        params, jnp.asarray(frames)
    )
    with torch.no_grad():
        tf, tc = port.frame_features(torch.from_numpy(frames))
    assert tuple(tf.shape) == (2, H // 8, W // 8, 256)
    # f32 on both sides; summation order differs across ~10 layers of
    # matmuls, convs and LayerNorms over unit-scale activations.
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("learned_init", [False, True], ids=["mhs", "init_hidden"])
def test_sk_update_block_matches_flax(models, learned_init):
    """One joint update step (motion encoder, GMA aggregate through K2's
    wrapper, PCBlock 'gru', flow head, mask head).  With learned_init the
    motion hidden state is None and the converted init_hidden_state is
    read."""
    _, _, flat, _ = models
    rng = np.random.default_rng(2)
    b, n, h, w = 1, 3, 9, 11
    bn = b * n
    planes = 2 * CFG["corr_levels"] * (2 * CFG["corr_radius"] + 1) ** 2

    def rand(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    net, inp = np.tanh(rand(bn, h, w, 128)), np.maximum(rand(bn, h, w, 128), 0)
    corr, flow = rand(bn, h, w, planes), rand(bn, h, w, 4, s=3.0)
    q, k = rand(bn, h, w, 128, s=128 ** -0.5), rand(bn, h, w, 128)
    mhs = None if learned_init else rand(b, n, h, w, 48)

    prefix = "params/iteration/update_block/"
    sub = {p[len(prefix):]: v for p, v in flat.items() if p.startswith(prefix)}
    jblock = JaxSKUpdateBlockMOF(
        hidden_dim=128, corr_levels=CFG["corr_levels"],
        corr_radius=CFG["corr_radius"], dtype=jnp.float32, gma_impl="xla",
    )
    jout = jax.jit(jblock.apply, static_argnums=8)(
        {"params": unflatten_params(sub)},
        *(None if x is None else jnp.asarray(x) for x in (net, mhs, inp, corr, flow, q, k)),
        b,
    )

    block = SKUpdateBlockMOF(CFG["corr_levels"], CFG["corr_radius"]).eval()
    sd = state_dict_from_jax({"params/iteration/update_block/" + p: v for p, v in sub.items()})
    block.load_state_dict({k[len("update_block."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        tout = block(
            *(None if x is None else torch.from_numpy(x) for x in (net, mhs, inp, corr, flow, q, k)),
            b,
        )
    for name, j, t in zip(("net", "mhs", "mask", "delta"), jout, tout):
        assert tuple(t.shape) == j.shape, name
        # f32 both sides: five PCBlocks of 15x15 depthwise convs, summed in
        # another order.
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("b,h,w", [(1, 3, 4), (2, 9, 11)])
def test_upsample_flow_convex_matches_jax(b, h, w):
    rng = np.random.default_rng(b * 100 + h)
    flow = (3 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    mask = (2 * rng.standard_normal((b, h, w, 576))).astype(np.float32)
    ref = np.asarray(jax_upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)))
    got = upsample_flow_convex(torch.from_numpy(flow), torch.from_numpy(mask)).numpy()
    assert got.shape == (b, 8 * h, 8 * w, 2)
    # Softmax over 9 weights and a 9-term sum, in another order.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_upsample_mask_channel_order():
    """Channel c = k*64 + u*8 + v: a mask that puts all of sub-pixel
    (u, v)'s weight on neighbour k reads that neighbour's flow there."""
    flow = torch.arange(1, 1 + 3 * 3 * 2, dtype=torch.float32).reshape(1, 3, 3, 2)
    mask = torch.full((1, 3, 3, 576), -1e4)
    u, v, k = 2, 5, 7                 # neighbour k = 7 is (dy, dx) = (2, 1)
    mask[..., k * 64 + u * 8 + v] = 0.0
    up = upsample_flow_convex(flow, mask)
    # Output pixel (8*1 + u, 8*1 + v) of centre cell (1, 1) reads cell (2, 1).
    torch.testing.assert_close(up[0, 8 + u, 8 + v], 8 * flow[0, 2, 1])


@pytest.fixture(scope="module")
def clip_and_jax_flows(models):
    """One 5-frame clip and the JAX model's f32 flows for it."""
    jmodel, params, _, _ = models
    frames = np.random.default_rng(3).random((1, 5, H, W, 3), np.float32)
    jf, jb = jax.jit(jmodel.apply)(params, jnp.asarray(frames))
    return frames, np.asarray(jf), np.asarray(jb)


def test_mofnet_forward_matches_flax(models, clip_and_jax_flows):
    """The whole forward: Twins encoders, f32 dense pyramids (K1's
    wrapper), GMA (K2's wrapper), 2 refinement steps, convex upsample."""
    port = models[3]
    frames, jf, jb = clip_and_jax_flows
    with torch.no_grad():
        tf, tb = port(torch.from_numpy(frames))
    assert tuple(tf.shape) == (1, 3, H, W, 2)
    # As tests/test_torch_parity.py: f32 on both sides, two iterations of
    # feedback through the lookup amplify summation-order differences.
    np.testing.assert_allclose(tf.numpy(), jf, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=2e-3, atol=2e-3)


def test_tiled_stride1_engine_matches_jax(models):
    """compute_flows_tiled_stride1 on 7 frames of 72x176 with tile_size=96:
    two balanced 72x88 tiles per frame, the per-frame feature cache, window
    assembly at the clip's edges and the paste, against the JAX FlowEngine
    with the same converted weights (f32 volumes on both sides)."""
    from tpuflow.config import ModelConfig as JaxModelConfig
    from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine

    _, params, flat, _ = models
    frames = (np.random.default_rng(4).random((7, H, 2 * W, 3)) * 255).astype(np.uint8)

    jeng = JaxFlowEngine(JaxModelConfig(**CFG), params=params, dtype=jnp.float32)
    jeng.model = jeng.model.clone(corr_dtype=jnp.float32)
    jeng.load_model()
    ref = jeng.compute_flows_tiled_stride1(frames, tile_size=96)

    eng = FlowEngine(ModelConfig(**CFG), params=state_dict_from_jax(flat), device="cpu")
    eng.model.corr_dtype = torch.float32
    assert eng.load_model() == "preloaded"
    got = eng.compute_flows_tiled_stride1(frames, tile_size=96)
    assert got.shape == (7, H, 2 * W, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    # The one-frame entry point computes the same windows from scratch.
    for i in (0, 3, 6):
        np.testing.assert_allclose(
            eng.compute_flow_tiled(frames, i, tile_size=96), got[i], rtol=1e-5, atol=1e-5
        )


def test_bf16_path_is_as_close_to_f32_as_jax_bf16(models, clip_and_jax_flows):
    """The compute dtype of the card (bf16, with bf16 volumes) runs end to
    end, and the port's bf16 flows stray from the f32 reference no further
    than 1.5x the JAX package's own bf16 flows do (both drift by about 0.2
    px on average here).  This catches a dtype clash or an error well above
    bf16 rounding noise; finer precision choices (bf16 attention scores, a
    bf16 flow accumulator) stay below the noise at this depth, and this
    test does not see them."""
    jmodel, params, flat, _ = models
    frames, ref, _ = clip_and_jax_flows
    jbf16 = jmodel.clone(dtype=jnp.bfloat16, corr_dtype=jnp.bfloat16)
    jflow, _ = jax.jit(jbf16.apply)(params, jnp.asarray(frames))
    port = MOFNet(**CFG).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        tflow, _ = port(torch.from_numpy(frames))
    assert tflow.dtype == torch.float32
    jax_drift = np.abs(np.asarray(jflow) - ref).mean()
    port_drift = np.abs(tflow.numpy() - ref).mean()
    assert 0 < jax_drift < 1.0
    assert port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


# ---- every correlation formulation inside the model ----------------------


@pytest.mark.parametrize(
    "corr_impl,dense_lookup",
    [("flash2", "auto"), ("flash", "auto"), ("band", "auto"), ("direct", "auto"),
     ("gather", "auto"), ("auto", "patch")],
    ids=["flash2", "flash", "band", "direct", "gather", "dense-patch"],
)
def test_mofnet_corr_impls_match_flax(models, clip_and_jax_flows, corr_impl, dense_lookup):
    """MOFNet under each `corr_impl` / `dense_lookup` against the JAX MOFNet
    under the same setting (its Pallas kernels in interpret mode), f32
    volumes on both sides."""
    jmodel, params, flat, _ = models
    frames, dense_f, _ = clip_and_jax_flows
    jm = jmodel.clone(corr_impl=corr_impl, dense_lookup="xla" if dense_lookup == "auto" else dense_lookup)
    jf, jb = jax.jit(jm.apply)(params, jnp.asarray(frames))
    port = MOFNet(corr_dtype=torch.float32, corr_impl=corr_impl, dense_lookup=dense_lookup, **CFG).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.no_grad():
        tf, tb = port(torch.from_numpy(frames))
    # As test_mofnet_forward_matches_flax: f32 on both sides, two iterations
    # of feedback through the lookup amplify summation-order differences.
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2e-3, atol=2e-3)
    # And every formulation computes the dense path's flows.
    np.testing.assert_allclose(tf.numpy(), dense_f, rtol=2e-3, atol=2e-3)


def test_mofnet_rejects_unknown_dense_lookup():
    with pytest.raises(ValueError, match="dense_lookup"):
        MOFNet(dense_lookup="onehot", **CFG)


def test_encoder_frame_chunks_change_nothing(models, monkeypatch):
    """Encoders run over frames a bounded number of pixels at a time; the
    features are those of one call."""
    from tpuflow_torch.core import mofnet as port_mofnet

    port = models[3]
    frames = torch.from_numpy(np.random.default_rng(6).random((3, H, W, 3), np.float32))
    with torch.no_grad():
        whole = port.frame_features(frames)
        monkeypatch.setattr(port_mofnet, "ENCODER_CHUNK_PIXELS", H * W)   # one frame per call
        chunked = port.frame_features(frames)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---- the untiled engine entry points -------------------------------------


@pytest.fixture(scope="module")
def untiled_engines(models):
    """JAX engine with corr_impl='flash2' and the port's engine with 'auto'
    and the threshold lowered to 0, so that both run the large-grid
    formulation (FlashCorr2) untiled on 7 frames of 70x86 (padded to 72x88)."""
    from tpuflow.config import ModelConfig as JaxModelConfig
    from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.core.corr import FlashCorr2
    from tpuflow_torch.runtime.engine import FlowEngine

    _, params, flat, _ = models
    frames = (np.random.default_rng(5).random((7, H - 2, W - 2, 3)) * 255).astype(np.uint8)
    jeng = JaxFlowEngine(JaxModelConfig(corr_impl="flash2", **CFG), params=params, dtype=jnp.float32)
    jeng.model = jeng.model.clone(corr_dtype=jnp.float32)
    jeng.load_model()
    eng = FlowEngine(ModelConfig(**CFG), params=state_dict_from_jax(flat), device="cpu")
    eng.model.corr_dtype = torch.float32
    eng.model.materialize_threshold = 0
    eng.load_model()
    with torch.no_grad():
        enc = eng.model.encode(torch.zeros(1, 5, 16, 16, 3))
    assert isinstance(enc.corr_fwd, FlashCorr2) and isinstance(enc.corr_bwd, FlashCorr2)
    return frames, jeng, eng


def test_compute_flow_matches_jax(untiled_engines):
    frames, jeng, eng = untiled_engines
    got = eng.compute_flow(frames, 3)
    assert got.shape == (H - 2, W - 2, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, jeng.compute_flow(frames, 3), rtol=2e-3, atol=2e-3)


def test_compute_flow_batch_matches_jax(untiled_engines):
    """Two windows on the batch axis, both clipped at the clip's ends."""
    frames, jeng, eng = untiled_engines
    got = eng.compute_flow_batch(frames, [0, 6])
    assert got.shape == (2, H - 2, W - 2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jeng.compute_flow_batch(frames, [0, 6]), rtol=2e-3, atol=2e-3)
    # A window's flow does not depend on its neighbours in the batch, up to
    # the summation order another batch size gives convolutions and matmuls.
    np.testing.assert_allclose(eng.compute_flow(frames, 6), got[1], rtol=2e-3, atol=2e-3)


def test_compute_flows_strided_matches_jax(untiled_engines):
    """Windows start at -1, 2, 5: the port runs a batch of two, then a batch
    of one; the JAX engine fills its second batch with a window whose flows
    it drops.  Frames 1 and 4 are the middle interiors of their windows,
    and there the strided flow is the stride-1 flow of that frame: the same
    window, the same interior."""
    frames, jeng, eng = untiled_engines
    got = eng.compute_flows_strided(frames, window_batch=2)
    assert got.shape == (7, H - 2, W - 2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jeng.compute_flows_strided(frames, window_batch=2), rtol=2e-3, atol=2e-3)
    for i in (1, 4):
        np.testing.assert_allclose(got[i], eng.compute_flow(frames, i), rtol=2e-3, atol=2e-3)
    # Off the middle the window differs, and so does the flow.
    assert np.abs(got[3] - eng.compute_flow(frames, 3)).max() > 0.1


def test_untiled_and_single_tile_agree(untiled_engines):
    """A clip whose frames fit one tile goes to compute_flow from both tile
    entry points, as in the JAX engine (tpuflow/runtime/engine.py:487-488,
    683-693): their flows are compute_flow's, bit for bit."""
    frames, _, eng = untiled_engines
    np.testing.assert_array_equal(eng.compute_flow_tiled(frames, 2, tile_size=96), eng.compute_flow(frames, 2))
    stride1 = eng.compute_flows_tiled_stride1(frames[:3], tile_size=96)
    for i in range(3):
        np.testing.assert_array_equal(stride1[i], eng.compute_flow(frames[:3], i))


def test_get_model_info_matches_jax(untiled_engines):
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine

    _, jeng, eng = untiled_engines
    assert eng.get_model_info() == jeng.get_model_info()
    assert FlowEngine(ModelConfig(**CFG), device="cpu").get_model_info() == {"status": "not_loaded"}


# ---- the cnn encoder and BOFNet -------------------------------------------


@pytest.mark.parametrize("norm", ["instance", "group", "batch", "none"])
@pytest.mark.parametrize(
    "cin,planes,stride", [(16, 16, 1), (16, 24, 1), (16, 24, 2)], ids=["same", "widen", "stride2"]
)
def test_residual_block_matches_flax(norm, cin, planes, stride):
    """One ResidualBlock per norm, with and without the 1x1 `downsample`
    (width or stride changes), on an 18x23 grid: the stride-2 convs pad as
    flax 'SAME' does, unevenly on the even axis."""
    rng = np.random.default_rng(20 + cin + planes + stride)
    x = rng.standard_normal((2, 18, 23, cin)).astype(np.float32)
    jblock = JaxResidualBlock(planes, stride, norm)
    flat = random_flax_params(jblock, seed=21, example=jnp.zeros((1, 18, 23, cin)))
    ref = np.asarray(jblock.apply(unflatten_params(flat), jnp.asarray(x)))
    block = ResidualBlock(cin, planes, stride, norm).eval()
    block.load_state_dict(state_dict_from_jax(flat), strict=True)
    assert (block.downsample is None) == (stride == 1 and cin == planes)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, -(-18 // stride), -(-23 // stride), planes)
    # f32 both sides: two 3x3 convs and their norms, summed in another order.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cnn_models():
    """The JAX MOFNet and the port's with the cnn encoder (fnet instance
    norm, cnet the 'batch' stand-in) on one random flax param tree."""
    jmodel = JaxMOFNet(
        encoder="cnn", dtype=jnp.float32, corr_dtype=jnp.float32,
        dense_lookup="xla", gma_impl="xla", **CFG,
    )
    flat = random_flax_params(jmodel, seed=7)
    port = MOFNet(encoder="cnn", corr_dtype=torch.float32, **CFG).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jmodel, unflatten_params(flat), flat, port


def test_cnn_conversion_is_total(cnn_models):
    _, _, flat, port = cnn_models
    sd = state_dict_from_jax(flat)
    assert len(sd) == len(flat) and set(sd) == set(port.state_dict())
    assert isinstance(port.fnet, BasicEncoder) and isinstance(port.cnet, BasicEncoder)
    assert "fnet.norm1.weight" in sd and "cnet.norm1.weight" not in sd   # the stem's norm: instance only


def test_basic_encoder_frame_features_match_flax(cnn_models):
    """fnet and cnet (BasicEncoder) through frame_features, which scales the
    frames to [-1, 1] for this encoder too."""
    jmodel, params, _, port = cnn_models
    frames = np.random.default_rng(8).random((2, H, W, 3), np.float32)
    jf, jc = jax.jit(lambda p, x: jmodel.apply(p, x, method="frame_features"))(params, jnp.asarray(frames))
    with torch.no_grad():
        tf, tc = port.frame_features(torch.from_numpy(frames))
    assert tuple(tf.shape) == (2, H // 8, W // 8, 256) and tuple(tc.shape) == (2, H // 8, W // 8, 256)
    # As the Twins test: f32 both sides, ~10 layers summed in another order.
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)


def test_cnn_mofnet_forward_matches_flax(cnn_models):
    jmodel, params, _, port = cnn_models
    frames = np.random.default_rng(9).random((1, 5, H, W, 3), np.float32)
    jf, jb = jax.jit(jmodel.apply)(params, jnp.asarray(frames))
    with torch.no_grad():
        tf, tb = port(torch.from_numpy(frames))
    # As test_mofnet_forward_matches_flax.
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2e-3, atol=2e-3)


def test_bofnet_forward_matches_flax(models):
    """BOFNet at T = 3 (one interior frame, its forward and backward flows),
    built by build_model for architecture 'bof', against the JAX BOFNet on
    the same weights (BOF's param tree is MOF's)."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import build_model

    _, params, flat, _ = models
    frames = np.random.default_rng(10).random((1, 3, H, W, 3), np.float32)
    jbof = JaxBOFNet(
        encoder="twins", dtype=jnp.float32, corr_dtype=jnp.float32,
        dense_lookup="xla", gma_impl="xla", **CFG,
    )
    jf, jb = jax.jit(jbof.apply)(params, jnp.asarray(frames))
    port = build_model(ModelConfig(architecture="bof", sequence_length=3, **CFG), device="cpu")
    assert type(port) is BOFNet
    port.corr_dtype = torch.float32
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.no_grad():
        tf, tb = port(torch.from_numpy(frames))
    assert tuple(tf.shape) == tuple(tb.shape) == (1, 1, H, W, 2)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2e-3, atol=2e-3)
