"""The port's kernel modules against the JAX reference on the CPU.

K1 (tpuflow_torch.kernels.denselookup.dense_lookup) is held against the
JAX fused Pallas lookup kernel run in interpret mode, on the SAME volume
values: the JAX pyramid's grouped levels are unpacked to the port's flat
[N, lh, lw] layout.  K2 (flash_attention_fwd) is held against
flash_aggregate(interpret=True).  On the CPU both wrappers run their plain
PyTorch versions; the CUDA kernels are held against those on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.core.corr import DenseCorrPyramid as JaxDense
from tpuflow.core.corr import pyramid_level_dims
from tpuflow.core.gma import flash_aggregate

from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

from tpuflow_torch.core.corr import DenseCorrPyramid, corr_feature_dim, make_corr
from tpuflow_torch.kernels.denselookup import MAX_RADIUS, dense_lookup
from tpuflow_torch.kernels.flashattn import flash_attention_fwd, flash_attention_plain


def _flat_levels(pyr: JaxDense):
    """JAX grouped levels [N, nh_a, gw_a] -> flat [N, lh, lw] numpy."""
    out = []
    for lvl, vol in enumerate(pyr.pyramid):
        lh, lw = pyramid_level_dims(pyr.h2, pyr.w2, lvl)
        g = pyr.groups[lvl]
        nh = -(-lh // g)
        v = np.asarray(vol.astype(jnp.float32))[:, :nh, : g * lw]
        out.append(np.ascontiguousarray(v.reshape(v.shape[0], nh * g, lw)[:, :lh]))
    return out


def _jax_pyramid(rng, b, h, w, c, levels, dt):
    f1 = jnp.asarray(rng.standard_normal((b, h, w, c)), dt)
    f2 = jnp.asarray(rng.standard_normal((b, h, w, c)), dt)
    return JaxDense.build(f1, f2, levels), f1, f2


# Flows of up to +-1.5x the grid push whole windows off the plane at every
# level; 2x9x11 = 198 queries is a multiple of no power-of-two block.
@pytest.mark.parametrize("levels,radius", [(1, 2), (2, 4), (3, 2), (4, 4)])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_dense_lookup_matches_jax_fused_kernel(levels, radius, dt):
    rng = np.random.default_rng(7 + levels)
    b, h, w, c = 2, 9, 11, 32
    pyr, _, _ = _jax_pyramid(rng, b, h, w, c, levels, dt)
    flow = (rng.random((b, h, w, 2)) * 2 - 1).astype(np.float32) * np.array([1.5 * w, 1.5 * h], np.float32)
    ref = np.asarray(pyr.lookup(jnp.asarray(flow), radius, impl="interpret"))

    tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
    vols = [torch.from_numpy(v).to(tdt) for v in _flat_levels(pyr)]
    got = dense_lookup(vols, torch.from_numpy(flow), radius).numpy()
    assert got.shape == (b, h, w, corr_feature_dim(levels, radius))
    # Same volume values, same f32 two-stage bilinear: agreement to f32
    # rounding in either volume dtype.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_dense_lookup_zero_outside_plane():
    """A window entirely off the plane reads exact zeros; one straddling
    the edge keeps its in-plane taps."""
    vol = torch.arange(1, 1 + 4 * 5, dtype=torch.float32).reshape(1, 4, 5)
    far = torch.tensor([[[[100.0, 100.0]]]])
    assert torch.count_nonzero(dense_lookup([vol], far, 1)) == 0
    edge = torch.tensor([[[[-1.0, 0.0]]]])   # query (0, 0) moved to x = -1
    out = dense_lookup([vol], edge, 1).reshape(3, 3)  # [col j, row i]
    assert torch.all(out[:2] == 0)                     # columns x = -2, -1
    np.testing.assert_array_equal(out[2].numpy(), [0.0, 1.0, 6.0])  # x = 0, rows -1..1


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_pyramid_build_matches_jax(dt):
    rng = np.random.default_rng(2)
    pyr, f1, f2 = _jax_pyramid(rng, 2, 9, 11, 64, 4, dt)
    tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
    got = DenseCorrPyramid.build(
        torch.from_numpy(np.array(f1.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(f2.astype(jnp.float32))).to(tdt),
        4,
    )
    for lvl, (ref, vol) in enumerate(zip(_flat_levels(pyr), got.pyramid)):
        assert vol.dtype == tdt and vol.shape == ref.shape, lvl
        # f32: summation order only.  bf16: f32 accumulation in both, then
        # one bf16 rounding, which may land one bf16 ulp (2^-8 relative)
        # apart where the f32 sums differ in their last bits.
        tol = 1e-5 if dt == jnp.float32 else 2 ** -7
        np.testing.assert_allclose(vol.float().numpy(), ref, rtol=tol, atol=tol)


def test_make_corr_routes_and_refuses():
    """'auto' materializes small grids and recomputes above 168x168; no
    formulation of the JAX package is refused any more."""
    from tpuflow_torch.core.corr import BandCorrPyramid, FlashCorr2

    f = torch.zeros(1, 4, 6, 8)
    assert isinstance(make_corr(f, f, 2), DenseCorrPyramid)
    big = torch.zeros(1, 169, 169, 8)
    assert isinstance(make_corr(big, big, 4), FlashCorr2)
    assert isinstance(make_corr(f, f, 2, impl="dense"), DenseCorrPyramid)
    assert isinstance(make_corr(f, f, 2, impl="band"), BandCorrPyramid)


@pytest.mark.parametrize("b,h,w", [(2, 9, 11), (1, 6, 10)])
def test_flash_attention_matches_jax_flash_aggregate(b, h, w):
    rng = np.random.default_rng(5)
    d = 128
    q = (rng.standard_normal((b, h, w, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, h, w, d)).astype(np.float32)
    v = rng.standard_normal((b, h, w, d)).astype(np.float32)
    ref = np.asarray(flash_aggregate(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = flash_attention_fwd(
        *(torch.from_numpy(x.reshape(b, h * w, d)) for x in (q, k, v))
    ).numpy().reshape(b, h, w, d)
    # Both f32 softmax(q k^T) v; blockwise vs chunked sums only.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_flash_attention_plain_chunks_agree():
    """Query chunking (a ragged last chunk included) leaves the exact
    softmax unchanged."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 37, 128, generator=g) for _ in range(3))
    whole = torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v
    small = flash_attention_plain(q, k, v, budget=2 * 37 * 4 * 5)  # 5-row chunks
    torch.testing.assert_close(small, whole, rtol=1e-5, atol=1e-5)


_FLOW = torch.zeros(1, 3, 4, 2)


@pytest.mark.parametrize("call", [
    lambda: dense_lookup([torch.zeros(11, 3, 4)], _FLOW, 1),                    # N != B*h*w
    lambda: dense_lookup([torch.zeros(12, 3, 4, dtype=torch.float16)], _FLOW, 1),
    lambda: dense_lookup([torch.zeros(12, 3, 4)], _FLOW, MAX_RADIUS + 1),      # above the staging cap
    lambda: dense_lookup([torch.zeros(12, 3, 4)], _FLOW, -1),
    lambda: flash_attention_fwd(*(torch.zeros(1, 5, 64) for _ in range(3))),
], ids=["query_count", "fp16_volume", "radius_above_cap", "negative_radius", "head_dim"])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_dense_lookup_takes_the_radius_cap():
    """MAX_RADIUS itself is accepted, on a plane smaller than the window."""
    out = dense_lookup([torch.ones(12, 3, 4)], _FLOW, MAX_RADIUS)
    side = 2 * MAX_RADIUS + 1
    assert out.shape == (1, 3, 4, side * side)
    # Zero flow: each window covers the whole 3x4 plane of ones with whole-
    # pixel weights, so exactly 12 taps read 1 and the rest lie outside.
    assert torch.equal(out.sum(dim=-1), torch.full((1, 3, 4), 12.0))
