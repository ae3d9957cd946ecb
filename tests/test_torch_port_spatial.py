"""Spatial sharding of the port (tpuflow_torch.runtime.sharding
shard_spatial_forward, core/strips.py) on the CPU.

Meshes list the CPU several times: each slot's strip runs in a thread of
its own, as strips that share one card do.

Tolerances:
- Against the JAX package's shard_spatial_forward (2x4 mesh of 8 virtual
  CPU devices, the JAX test's shapes and configuration, f32 volumes on both
  sides): rtol = atol = 2e-3, the port's whole-model parity tolerance at
  this configuration (tests/test_torch_port_model.py), tighter than the JAX
  test's 2e-3 of max |flow| against its own unsharded forward.
- Against the port's unsharded forward, f32: max |diff| within 1e-5 of max
  |flow|.  The strips sum the same terms in another order (convolutions
  over a halo, norms over partial sums, attention over gathered keys);
  measured up to 3.3e-7 of max |flow| here.  A one-slot mesh is bit for bit.
- Per module, f32: within 1e-5 of the output's max |value| (the same
  reassociation); K1's plain version at row0 is bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuflow.core.mofnet import MOFNet as JaxMOFNet
from tpuflow.runtime import sharding as jsharding
from tpuflow.runtime.convert import unflatten_params
from tests.test_torch_port_model import one_torch_thread, random_flax_params  # noqa: F401 (autouse)
from tests.jax_learned_start import jax_learned_start  # noqa: F401 (autouse)

from tpuflow_torch.core import corr as tcorr
from tpuflow_torch.core import strips
from tpuflow_torch.core.encoders import (
    GlobalSubSampleAttn,
    GroupNorm,
    LocallyGroupedAttn,
    PosConv,
    SameConv2d,
    TwinsPatchEmbed,
)
from tpuflow_torch.core.gma import Aggregate, materialize_attention
from tpuflow_torch.core.memflownet import MemFlowNet
from tpuflow_torch.core.mofnet import MOFNet
from tpuflow_torch.core.sk import PCBlock4, SKUpdateBlockMOF
from tpuflow_torch.core.update import upsample_flow_convex
from tpuflow_torch.kernels.denselookup import dense_lookup, dense_lookup_plain
from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain
from tpuflow_torch.runtime.convert import state_dict_from_jax
from tpuflow_torch.runtime.engine import init_random_
from tpuflow_torch.runtime.sharding import Mesh, shard_sizes, shard_spatial_forward, spatial_sharding

CPU = torch.device("cpu")
TINY = dict(encoder="cnn", corr_levels=2, corr_radius=2, decoder_depth=2, feature_dim=64,
            hidden_dim=32, context_dim=32)
UNSHARDED_TOL = 1e-5


def cpu_mesh(data: int, spatial: int) -> Mesh:
    return Mesh([[CPU] * spatial] * data, ("data", "spatial"))


def rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_models():
    """The JAX test's configuration (tests/test_sharding.py tiny_cfg: cnn
    encoder, T = 3, 2 levels, radius 2, 2 iterations, feature_dim 64, hidden
    and context 32) on both sides, one random flax param tree, f32 volumes."""
    jmodel = JaxMOFNet(encoder="cnn", dtype=jnp.float32, corr_dtype=jnp.float32, dense_lookup="xla",
                       gma_impl="xla", **{k: v for k, v in TINY.items() if k != "encoder"})
    flat = random_flax_params(jmodel, seed=11, h=64, w=48)
    # K2 takes VideoFlow's 128-wide context only; GMA at a width of 32 runs
    # the chunked exact softmax, the JAX package's formulation off the TPU.
    port = MOFNet(corr_dtype=torch.float32, gma_impl="xla", **TINY).eval()
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jmodel, unflatten_params(flat), port


@pytest.fixture(scope="module")
def tiny_frames():
    return np.random.default_rng(7).random((2, 3, 64, 48, 3)).astype(np.float32)


def test_spatial_forward_matches_jax_shard_spatial_forward(tiny_models, tiny_frames):
    """The port's shard_spatial_forward over a ('data' 2, 'spatial' 4) mesh
    of the CPU against the JAX package's over 8 virtual CPU devices, at
    tests/test_sharding.py:177-205's shapes (H = 64: four strips of 16 rows,
    2 feature rows each)."""
    jmodel, params, port = tiny_models
    assert len(jax.devices()) >= 8
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "spatial"))
    jfn = jsharding.shard_spatial_forward(lambda p, x: jmodel.apply(p, x), jmesh, batch_ndim=5, h_axis=2)
    jf, jb = (np.asarray(a) for a in jfn(params, jnp.asarray(tiny_frames)))
    fn = shard_spatial_forward(port, cpu_mesh(2, 4), 5, 2)
    with torch.no_grad():
        tf, tb = fn(port.state_dict(), torch.from_numpy(tiny_frames))
    assert fn.groups[0].rows == [2, 2, 2, 2] and len(fn.groups) == 2
    assert tf.shape == jf.shape == (2, 1, 64, 48, 2)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# against the port's unsharded forward
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def twins_model():
    model = MOFNet(corr_levels=2, corr_radius=2, decoder_depth=2, corr_dtype=torch.float32).eval()
    init_random_(model, 3)
    return model


def sharded_vs_unsharded(model, frames: torch.Tensor, data: int, spatial: int):
    """(relative max |diff| of both flow directions, the sharded call)."""
    fn = shard_spatial_forward(model, cpu_mesh(data, spatial), 5, 2)
    with torch.no_grad():
        ref = model(frames)
        got = fn(model.state_dict(), frames)
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    return max(rel_err(g, r) for g, r in zip(got, ref)), fn


@pytest.mark.parametrize("data,spatial", [(1, 2), (1, 3), (2, 4), (1, 4)])
def test_spatial_slots_match_unsharded(tiny_models, tiny_frames, data, spatial):
    """1, 2, 3 (uneven: 3, 3 and 2 feature rows) and 4 'spatial' slots, with
    one or two 'data' slots, on the cnn encoder (GroupNorm statistics over
    the strips, strided convs' halos)."""
    _, _, port = tiny_models
    err, fn = sharded_vs_unsharded(port, torch.from_numpy(tiny_frames), data, spatial)
    assert fn.groups[0].rows == shard_sizes(8, spatial)
    assert err <= UNSHARDED_TOL, err


def test_twins_windows_across_strips_match_unsharded(twins_model):
    """Twins encoder (the product's) on a 64-row frame over four strips: its
    1/4 map has 16 rows, 4 per strip, so the 7-row windows of the locally
    grouped attention span two and three strips, and the bottom window is
    padded past the frame."""
    frames = torch.from_numpy(np.random.default_rng(12).random((1, 3, 64, 48, 3)).astype(np.float32))
    err, fn = sharded_vs_unsharded(twins_model, frames, 1, 4)
    assert fn.groups[0].rows == [2, 2, 2, 2]
    assert err <= UNSHARDED_TOL, err


def test_one_slot_mesh_is_bit_for_bit(tiny_models, tiny_frames):
    _, _, port = tiny_models
    fn = shard_spatial_forward(port, cpu_mesh(1, 1), 5, 2)
    with torch.no_grad():
        ref = port(torch.from_numpy(tiny_frames))
        got = fn(port.state_dict(), torch.from_numpy(tiny_frames))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert not fn.groups[0].fetched_bytes[0]


@pytest.fixture
def configured(tiny_models):
    """The tiny model with its options restored after the test."""
    _, _, port = tiny_models
    saved = (port.corr_impl, port.dense_lookup, port.gma_impl, port.materialize_threshold)
    yield port
    port.corr_impl, port.dense_lookup, port.gma_impl, port.materialize_threshold = saved


@pytest.mark.parametrize("threshold", [None, 47])
def test_auto_decides_on_the_whole_grid(configured, tiny_frames, threshold, monkeypatch):
    """'auto' on both sides of the materialization threshold, decided on the
    frame's 8x6 = 48-cell grid: the default threshold materializes (K1's
    plain version, from each strip's row0), a threshold of 47 recomputes
    with FlashCorr2 in every strip, though each strip's own grid (12 cells)
    lies below it."""
    port = configured
    if threshold is not None:
        port.materialize_threshold = threshold
    built = []
    for cls in (tcorr.DenseCorrPyramid, tcorr.FlashCorr2):
        orig = cls.build.__func__
        monkeypatch.setattr(cls, "build", classmethod(
            lambda c, *a, _orig=orig, **k: built.append(c.__name__) or _orig(c, *a, **k)))
    err, _ = sharded_vs_unsharded(port, torch.from_numpy(tiny_frames), 1, 4)
    assert err <= UNSHARDED_TOL, err
    want = "FlashCorr2" if threshold else "DenseCorrPyramid"
    assert set(built) == {want} and len(built) == 2 + 2 * 4   # unsharded: 2; four strips: 2 each


@pytest.mark.parametrize("corr_impl,dense_lookup", [
    ("dense", "patch"), ("dense", "xla"), ("gather", "auto"), ("direct", "auto"),
    ("flash", "auto"), ("flash2", "auto"), ("band", "auto"),
])
def test_corr_impls_match_unsharded(configured, tiny_frames, corr_impl, dense_lookup):
    port = configured
    port.corr_impl, port.dense_lookup = corr_impl, dense_lookup
    err, _ = sharded_vs_unsharded(port, torch.from_numpy(tiny_frames), 1, 3)
    assert err <= UNSHARDED_TOL, err


@pytest.mark.parametrize("gma_impl", ["auto", "xla"])
def test_gma_impls_match_unsharded(twins_model, gma_impl):
    """GMA from each strip's queries to the frame's keys (the 128-wide
    context): K2's plain version ('auto') and the probabilities
    materialized per strip ('xla')."""
    frames = torch.from_numpy(np.random.default_rng(13).random((1, 3, 64, 48, 3)).astype(np.float32))
    twins_model.gma_impl = gma_impl
    try:
        err, _ = sharded_vs_unsharded(twins_model, frames, 1, 4)
    finally:
        twins_model.gma_impl = "auto"
    assert err <= UNSHARDED_TOL, err


# ---------------------------------------------------------------------------
# per module: each strip-aware operation against the unsharded one
# ---------------------------------------------------------------------------
def run_in_strips(fn, inputs, rows, scales, out_dim: int = 1):
    """fn(*inputs) with inputs[i] cut along dim 1 (NHWC and tokens' rows) or
    2 (NCHW) into strips of rows[j] * scales[i] rows (scale None: the
    input whole), one thread per strip with the strip current; the strips'
    outputs concatenated along out_dim."""
    group = strips.StripGroup(rows)
    outs, errors = [None] * len(rows), []

    def run(j):
        token = strips.enter(strips.Strip(group, j))
        try:
            parts = [x if s is None else x.narrow(d, s * group.starts[j], s * rows[j])
                     for x, (d, s) in zip(inputs, scales)]
            with torch.no_grad():
                outs[j] = fn(*parts)
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)
            group.abort()
        finally:
            strips.leave(token)

    threads = [threading.Thread(target=run, args=(j,)) for j in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return torch.cat(outs, dim=out_dim)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rand(*shape, seed=0):
    return torch.randn(shape, generator=_gen(seed))


def _module(cls, *args, seed=0, **kw):
    torch.manual_seed(seed)
    mod = cls(*args, **kw).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=_gen(seed + 1)))
    return mod


def _tokens_op(mod):
    """A token module (x, size) on a map [B, h, w, C]."""
    return lambda x: mod(x.reshape(x.shape[0], -1, x.shape[3]), (x.shape[1], x.shape[2])).reshape(x.shape)


def _corr_lookup(impl, dense_lookup="auto", border="zeros"):
    def op(f1, f2, flow):
        strip = strips.current()
        full = f2 if strip is None else strip.gather(f2, 1)
        c = tcorr.make_corr(f1, full, 3, impl=impl, row0=strips.first_row(f1.shape[1]))
        if isinstance(c, tcorr.DenseCorrPyramid):
            return c.lookup(flow, 2, impl=dense_lookup, border=border)
        return c.lookup(flow, 2, border=border)
    return op


def _aggregate(impl, materialized=False, dim_head=128):
    agg = _module(Aggregate, 128, dim_head, seed=5)
    agg.impl = impl

    def op(q, k, fmap):
        strip = strips.current()
        keys = k if strip is None else strip.gather(k, 1)
        attn = materialize_attention(q, keys, torch.float32) if materialized else None
        return agg(q, keys, fmap, attn)
    return op


# Each case: (op, inputs, (dim, scale) per input: the input's rows per
# feature row, None for an input given whole, output dim).  Frames of 8
# feature rows (64 pixels) over four strips of 2, or three of 3, 3 and 2.
MODULE_CASES = {
    "patch_embed": (lambda: (lambda m: (lambda x: m(x)[0].reshape(x.shape[0], x.shape[2] // 4, -1, 16)))(
        _module(TwinsPatchEmbed, 3, 16, 4)), [_rand(2, 3, 64, 48)], [(2, 8)], 1),
    "locally_grouped_attn": (lambda: _tokens_op(_module(LocallyGroupedAttn, 16, 2, 7)),
                             [_rand(2, 16, 12, 16)], [(1, 2)], 1),
    "global_subsample_attn_sr8": (lambda: _tokens_op(_module(GlobalSubSampleAttn, 16, 2, 8)),
                                  [_rand(2, 16, 12, 16)], [(1, 2)], 1),
    "global_subsample_attn_sr4": (lambda: _tokens_op(_module(GlobalSubSampleAttn, 16, 2, 4)),
                                  [_rand(2, 8, 6, 16)], [(1, 1)], 1),
    "pos_conv": (lambda: _tokens_op(_module(PosConv, 16)), [_rand(2, 16, 12, 16)], [(1, 2)], 1),
    "same_conv_7x7_s2": (lambda: _module(SameConv2d, 3, 8, 7, 2), [_rand(2, 3, 64, 48)], [(2, 8)], 2),
    "same_conv_3x3_s1": (lambda: _module(SameConv2d, 8, 8, 3, 1), [_rand(2, 8, 32, 24)], [(2, 4)], 2),
    "same_conv_3x3_s2": (lambda: _module(SameConv2d, 8, 8, 3, 2), [_rand(2, 8, 32, 24)], [(2, 4)], 2),
    "same_conv_1x1_s2": (lambda: _module(SameConv2d, 8, 8, 1, 2), [_rand(2, 8, 16, 12)], [(2, 2)], 2),
    "group_norm_instance": (lambda: _module(GroupNorm, 8, 8), [_rand(2, 8, 32, 24) + 3], [(2, 4)], 2),
    "group_norm_batch": (lambda: _module(GroupNorm, 1, 8), [_rand(2, 8, 16, 12) * 2], [(2, 2)], 2),
    "pcblock4_15x15": (lambda: _module(PCBlock4, 16, 8, (1, 15)), [_rand(2, 8, 6, 16)], [(1, 1)], 1),
    "pcblock4_gru_7x7": (lambda: _module(PCBlock4, 16, 8, (1, 7)), [_rand(2, 8, 6, 16)], [(1, 1)], 1),
    "mask_head": (lambda: _module(SKUpdateBlockMOF, 2, 2, 32, context_dim=32).upsample_mask,
                  [_rand(2, 8, 6, 32)], [(1, 1)], 1),
    "convex_upsample": (lambda: upsample_flow_convex, [_rand(2, 8, 6, 2) * 3, _rand(2, 8, 6, 576, seed=1)],
                        [(1, 1), (1, 1)], 1),
    "aggregate_k2": (lambda: _aggregate("auto"), [_rand(2, 8, 6, 128) * 0.1, _rand(2, 8, 6, 128, seed=1),
                                                  _rand(2, 8, 6, 128, seed=2)], [(1, 1)] * 3, 1),
    "aggregate_xla_projected": (lambda: _aggregate("xla", dim_head=32), [
        _rand(2, 8, 6, 32), _rand(2, 8, 6, 32, seed=1), _rand(2, 8, 6, 128, seed=2)], [(1, 1)] * 3, 1),
    "aggregate_materialized": (lambda: _aggregate("xla", True),
                               [_rand(2, 8, 6, 128) * 0.1, _rand(2, 8, 6, 128, seed=1),
                                _rand(2, 8, 6, 128, seed=2)], [(1, 1)] * 3, 1),
}
CORR_INPUTS = [_rand(2, 8, 6, 16), _rand(2, 8, 6, 16, seed=1), _rand(2, 8, 6, 2, seed=2) * 3]
for _name, _impl, _dl in (("dense_k1", "dense", "auto"), ("dense_patch", "dense", "patch"),
                          ("dense_xla", "dense", "xla"), ("flash2", "flash2", "auto"), ("flash", "flash", "auto"),
                          ("band", "band", "auto"), ("gather", "gather", "auto"), ("direct", "direct", "auto")):
    MODULE_CASES[f"corr_{_name}"] = (lambda i=_impl, d=_dl: _corr_lookup(i, d), CORR_INPUTS, [(1, 1)] * 3, 1)
MODULE_CASES["corr_dense_clamp"] = (lambda: _corr_lookup("dense", border="clamp"), CORR_INPUTS, [(1, 1)] * 3, 1)


@pytest.mark.parametrize("rows", [[2, 2, 2, 2], [3, 3, 2]], ids=["4strips", "3strips"])
@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_strip_aware_module_matches_unsharded(case, rows):
    make, inputs, dims, out_dim = MODULE_CASES[case]
    op = make()
    with torch.no_grad():
        ref = op(*inputs)
    scales = [(d, s) for d, s in dims]
    got = run_in_strips(op, inputs, rows, scales, out_dim)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=UNSHARDED_TOL * ref.abs().max().item())


def test_strips_out_of_step_raise():
    """Strips that make different exchanges fail with the tags, not with a
    wrong tensor."""
    x = _rand(1, 8, 4, 3)

    def op(part):
        strip = strips.current()
        if strip.index == 0:
            return strip.gather(part, 1)
        return strip.all_sum(part)

    with pytest.raises(RuntimeError, match="out of step"):
        run_in_strips(op, [x], [2, 2, 2, 2], [(1, 1)])


# ---------------------------------------------------------------------------
# kernel plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,row0", [(3, 0), (3, 3), (3, 6), (2, 9)])
def test_dense_lookup_plain_row0_is_the_unsharded_rows(rows, row0):
    """K1's plain version (and its wrapper on the CPU) on a strip's queries
    from row0 equals the unsharded lookup's rows bit for bit: the volumes
    of a strip are the frame's volumes of its queries."""
    b, h, w, r, levels = 2, 11, 7, 2, 3
    g = _gen(4)
    vols = [torch.randn((b * h * w, 11 >> l, 7 >> l), generator=g) for l in range(levels)]
    flow = torch.randn((b, h, w, 2), generator=g) * 4
    full = dense_lookup_plain(vols, flow, r)
    sv = [v.reshape(b, h, w, *v.shape[1:])[:, row0 : row0 + rows].reshape(-1, *v.shape[1:]).contiguous()
          for v in vols]
    sf = flow[:, row0 : row0 + rows].contiguous()
    assert torch.equal(dense_lookup_plain(sv, sf, r, row0=row0), full[:, row0 : row0 + rows])
    assert torch.equal(dense_lookup(sv, sf, r, row0=row0), full[:, row0 : row0 + rows])
    if row0:
        assert not torch.equal(dense_lookup_plain(sv, sf, r), full[:, row0 : row0 + rows])
    with pytest.raises(ValueError, match="row0"):
        dense_lookup(sv, sf, r, row0=-1)


@pytest.mark.parametrize("sq,sk", [(37, 130), (130, 37), (1, 64), (64, 1)])
def test_flash_attention_plain_query_and_key_counts(sq, sk):
    """K2's plain version (and its wrapper on the CPU) with Sq != Sk against
    a softmax in f32 over all keys: within 1e-5 (outputs of order 1; the same
    f32 products, the matrix products summed in another order for other
    chunks); a narrow chunk budget changes nothing."""
    g = _gen(5)
    q = torch.randn((3, sq, 128), generator=g) * 128**-0.5
    k, v = torch.randn((3, sk, 128), generator=g), torch.randn((3, sk, 128), generator=g)
    ref = torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v
    for got in (flash_attention_plain(q, k, v), flash_attention_fwd(q, k, v),
                flash_attention_plain(q, k, v, budget=4 * 3 * sk * 5)):
        assert got.shape == (3, sq, 128)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="Sk"):
        flash_attention_fwd(q, k[:, :, :64], v)


# ---------------------------------------------------------------------------
# the API and failures
# ---------------------------------------------------------------------------
def test_spatial_sharding_and_shard_sizes():
    mesh = cpu_mesh(2, 4)
    spec = spatial_sharding(mesh, 5, 2)
    assert spec.spec == ("data", None, "spatial", None, None) and spec.h_axis == 2
    assert spec.slots().shape == (2, 4)
    assert spatial_sharding(Mesh([CPU] * 3, ("spatial",)), 5, 2).slots().shape == (1, 3)
    assert spatial_sharding(Mesh([CPU] * 3), 5, 2).slots().shape == (3, 1)
    assert shard_sizes(135, 4) == [34, 34, 34, 33] and shard_sizes(8, 4) == [2, 2, 2, 2]
    assert shard_sizes(8, 3) == [3, 3, 2]


def test_shard_spatial_forward_refuses(tiny_models, tiny_frames):
    _, _, port = tiny_models
    memflow = MemFlowNet(corr_levels=2, corr_radius=2, decoder_depth=1)
    with pytest.raises(TypeError, match="MemFlowNet"):
        shard_spatial_forward(memflow, cpu_mesh(1, 2), 5, 2)
    with pytest.raises(ValueError, match="h_axis"):
        shard_spatial_forward(port, cpu_mesh(1, 2), 5, 3)
    fn = shard_spatial_forward(port, cpu_mesh(1, 2), 5, 2)
    x = torch.from_numpy(tiny_frames)
    with pytest.raises(ValueError, match="multiple of 8"):
        fn(port.state_dict(), x[:, :, :60])
    with pytest.raises(ValueError, match="dims"):
        fn(port.state_dict(), x[0])
    with pytest.raises(ValueError, match="multiple of 8"):
        shard_spatial_forward(port, cpu_mesh(1, 9), 5, 2)(port.state_dict(), x)


def test_one_failing_strip_fails_the_call(tiny_models, tiny_frames, monkeypatch):
    """A strip that raises aborts the others' waits: the call raises that
    strip's error within seconds, and no strip thread is left alive."""
    import tpuflow_torch.core.mofnet as mofnet

    _, _, port = tiny_models
    orig = mofnet.upsample_flow_convex

    def failing(flow, mask):
        if strips.current().index == 2:
            raise ArithmeticError("strip 2 failed")
        return orig(flow, mask)

    monkeypatch.setattr(mofnet, "upsample_flow_convex", failing)
    fn = shard_spatial_forward(port, cpu_mesh(2, 4), 5, 2)
    t0 = time.perf_counter()
    with pytest.raises(ArithmeticError, match="strip 2 failed"):
        with torch.no_grad():
            fn(port.state_dict(), torch.from_numpy(tiny_frames))
    assert time.perf_counter() - t0 < 30
    assert not [t for t in threading.enumerate() if t.name.startswith("strip-") and t.is_alive()]
