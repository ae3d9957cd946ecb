"""The port's correlation formulations against the JAX package's on the CPU.

Every class of tpuflow_torch.core.corr is built from the same numpy
features (drawn from a seed) as its JAX class and looked up with the same
flows; the JAX Pallas kernels run in interpret mode, as the JAX package's
own tests run them.  On the CPU the port's four patch wrappers run their
plain PyTorch versions; the CUDA kernels are held against those on the card
by chip_smoke.py.

Tolerances: f32 1e-5 where both sides hold the same volume entries (level
0, the exact-patch kernels), 2e-4 where pooled levels are summed in another
order, bf16 three bf16 ulps (3 * 2^-7) of the output's scale: one ulp of
difference in a stored entry and the storage-dtype bilinear of the epilogue.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuflow.core import corr as jcorr
from tpuflow.kernels.bandlookup import band_patch_level as jax_band_patch_level
from tpuflow.kernels.denselookup import dense_patch_level as jax_dense_patch_level
from tpuflow.kernels.flashcorr import flash_patch_level as jax_flash_patch_level
from tpuflow.kernels.flashcorr import pad_f2_level
from tpuflow.kernels.flashcorr2 import flash2_patch_level as jax_flash2_patch_level
from tpuflow.kernels.flashcorr2 import pack_f2_level

from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

from tpuflow_torch.core import corr as tcorr
from tpuflow_torch.core.mofnet import MOFNet
from tpuflow_torch.kernels.bandlookup import band_patch_level
from tpuflow_torch.kernels.denselookup import dense_lookup, dense_patch_level
from tpuflow_torch.kernels.flashcorr import flash_patch_level
from tpuflow_torch.kernels import bandlookup as tband
from tpuflow_torch.kernels import denselookup as tdense
from tpuflow_torch.kernels import flashcorr2 as tflashcorr2
from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level, flash2_patch_level_plain

B, H, W, C, LEVELS = 2, 16, 24, 32, 3
BF16_TOL = 3 * 2.0**-7
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def features(dt: str, seed: int = 23):
    """(f1, f2) as f32 numpy arrays already rounded to `dt`, so both sides
    start from the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.standard_normal((B, H, W, C)).astype(np.float32)
        out.append(np.asarray(jnp.asarray(x, JDT[dt]).astype(jnp.float32)))
    return tuple(out)


def flows(sigma: float) -> np.ndarray:
    """N(0, 6): windows mostly in the plane; N(0, 30): most cross its border
    or leave it."""
    return np.random.default_rng(int(sigma)).normal(0, sigma, (B, H, W, 2)).astype(np.float32)


def to_jax(x, dt):
    return jnp.asarray(x, JDT[dt])


def to_torch(x, dt):
    return torch.from_numpy(np.array(x)).to(TDT[dt])


# name -> (JAX constructor, port constructor); each takes (f1, f2).
CLASSES = {
    "gather": (lambda a, b: jcorr.CorrPyramid.build(a, b, LEVELS),
               lambda a, b: tcorr.CorrPyramid.build(a, b, LEVELS)),
    "direct": (lambda a, b: jcorr.OnTheFlyCorr.build(a, b, LEVELS),
               lambda a, b: tcorr.OnTheFlyCorr.build(a, b, LEVELS)),
    "flash2": (lambda a, b: jcorr.FlashCorr2.build(a, b, LEVELS),
               lambda a, b: tcorr.FlashCorr2.build(a, b, LEVELS)),
    "flash_all": (lambda a, b: jcorr.FlashCorr.build(a, b, LEVELS, flash_levels=LEVELS),
                  lambda a, b: tcorr.FlashCorr.build(a, b, LEVELS, flash_levels=LEVELS)),
    "flash_hybrid": (lambda a, b: jcorr.FlashCorr.build(a, b, LEVELS, flash_levels=1),
                     lambda a, b: tcorr.FlashCorr.build(a, b, LEVELS, flash_levels=1)),
    "band": (lambda a, b: jcorr.BandCorrPyramid.build(a, b, LEVELS),
             lambda a, b: tcorr.BandCorrPyramid.build(a, b, LEVELS)),
    "dense_patch": (lambda a, b: jcorr.DenseCorrPyramid.build(a, b, LEVELS),
                    lambda a, b: tcorr.DenseCorrPyramid.build(a, b, LEVELS)),
}


@functools.lru_cache(maxsize=None)
def jax_lookup(name: str, dt: str, radius: int):
    """One jitted build + lookup per (class, dtype, radius); both flow
    draws reuse it."""
    build = CLASSES[name][0]
    kw = {"impl": "patch"} if name == "dense_patch" else {}
    f1, f2 = (to_jax(x, dt) for x in features(dt))
    return jax.jit(lambda flow: build(f1, f2).lookup(flow, radius, **kw))


# Each (class, dtype, radius) is one JAX compile of a Pallas kernel in
# interpret mode, so bf16 runs at the model's radius only.
@pytest.mark.parametrize("sigma", [6.0, 30.0], ids=["inside", "border"])
@pytest.mark.parametrize("dt,radius", [("f32", 3), ("f32", 4), ("bf16", 4)])
@pytest.mark.parametrize("name", list(CLASSES))
def test_class_matches_jax(name, dt, radius, sigma):
    """Build + lookup of each port class against its JAX class."""
    flow = flows(sigma)
    ref = np.asarray(jax_lookup(name, dt, radius)(jnp.asarray(flow)))
    f1, f2 = (to_torch(x, dt) for x in features(dt))
    obj = CLASSES[name][1](f1, f2)
    kw = {"impl": "patch"} if name == "dense_patch" else {}
    got = obj.lookup(torch.from_numpy(flow), radius, **kw)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape == (B, H, W, tcorr.corr_feature_dim(LEVELS, radius))
    if dt == "bf16":
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(got - ref).max() <= BF16_TOL * scale
        return
    ncs = (2 * radius + 1) ** 2
    # Level 0: the same entries on both sides, f32 rounding only.
    np.testing.assert_allclose(got[..., :ncs], ref[..., :ncs], rtol=1e-5, atol=1e-5)
    # Pooled levels: 2x2 means and 32-long dots summed in another order.
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("name", [n for n in CLASSES if n != "gather"])
def test_port_formulations_agree_with_gather(name, radius):
    """Within the port, f32: every formulation gives CorrPyramid's features
    (volume pooling against feature pooling: summation order only)."""
    f1, f2 = (to_torch(x, "f32") for x in features("f32"))
    kw = {"impl": "patch"} if name == "dense_patch" else {}
    for sigma in (6.0, 30.0):
        flow = torch.from_numpy(flows(sigma))
        ref = tcorr.CorrPyramid.build(f1, f2, LEVELS).lookup(flow, radius)
        got = CLASSES[name][1](f1, f2).lookup(flow, radius, **kw)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


def test_all_pairs_and_pyramid_match_jax():
    f1, f2 = features("f32")
    ref = jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    got = tcorr.all_pairs_correlation(to_torch(f1, "f32"), to_torch(f2, "f32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for a, b in zip(tcorr.build_corr_pyramid(got, LEVELS), jcorr.build_corr_pyramid(ref, LEVELS)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "patch"])
def test_dense_lookup_impls_agree(impl):
    """Both `dense_lookup` values read the same f32 volume the same way."""
    f1, f2 = (to_torch(x, "f32") for x in features("f32"))
    pyr = tcorr.DenseCorrPyramid.build(f1, f2, LEVELS)
    flow = torch.from_numpy(flows(30.0))
    ref = tcorr.CorrPyramid.build(f1, f2, LEVELS).lookup(flow, 4)
    torch.testing.assert_close(pyr.lookup(flow, 4, impl=impl), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["pallas", "interpret", "onehot"])
def test_dense_lookup_rejects_unknown_impl(impl):
    """The JAX package's kernel backend names select nothing here: 'pallas'
    and 'interpret' are the kernel ('auto'), and K1's plain version is
    reached only by calling `dense_lookup_plain`, never as an option of the
    model.  ('xla', the JAX package's differentiable formulation, is an
    option: tests/test_torch_port_sharding.py.)"""
    f = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="dense_lookup"):
        tcorr.DenseCorrPyramid.build(f, f, 2).lookup(torch.zeros(1, 4, 6, 2), 2, impl=impl)
    with pytest.raises(ValueError, match="dense_lookup"):
        MOFNet(dense_lookup=impl)


@pytest.mark.parametrize("impl", ["auto", "patch"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_level_offset_matches_jax(dt, impl):
    """A sidecar pyramid that holds levels 1.. only: stored level i is
    sampled at scale 2^(i+1), in K1 and in the patch path."""
    f1, f2 = features(dt)
    joff = jcorr.DenseCorrPyramid.build(
        to_jax(f1, dt), jcorr._avg_pool_features(to_jax(f2, dt)), LEVELS - 1)
    joff = jcorr.DenseCorrPyramid(joff.pyramid, (B, H, W), (H, W), level_offset=1)
    flow = flows(6.0)
    ref = np.asarray(joff.lookup(jnp.asarray(flow), 3, impl="interpret" if impl == "auto" else "patch"))
    sub = tcorr.DenseCorrPyramid.build(
        to_torch(f1, dt), tcorr._avg_pool_features(to_torch(f2, dt)), LEVELS - 1)
    got = tcorr.DenseCorrPyramid(sub.pyramid, level_offset=1).lookup(torch.from_numpy(flow), 3, impl=impl)
    tol = 1e-5 if dt == "f32" else BF16_TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    assert np.abs(ref).max() > 0.5            # the windows do read the planes


MAKE_CORR_TYPES = {
    "materialized": "DenseCorrPyramid", "dense": "DenseCorrPyramid", "gather": "CorrPyramid",
    "direct": "OnTheFlyCorr", "flash": "FlashCorr", "flash2": "FlashCorr2",
    "band": "BandCorrPyramid", "auto": "DenseCorrPyramid",
}


@pytest.mark.parametrize("impl", list(MAKE_CORR_TYPES))
def test_make_corr_dispatch(impl):
    """Every `impl` of the JAX make_corr is accepted and gives the class of
    the same name."""
    f = np.zeros((1, 4, 6, 8), np.float32)
    got = tcorr.make_corr(torch.from_numpy(f), torch.from_numpy(f), 2, impl=impl)
    ref = jcorr.make_corr(jnp.asarray(f), jnp.asarray(f), 2, impl=impl)
    assert type(got).__name__ == type(ref).__name__ == MAKE_CORR_TYPES[impl]


def test_make_corr_auto_threshold():
    """'auto' materializes at or below the threshold and recomputes with
    FlashCorr2 above it, on every device (the JAX package detours to
    OnTheFlyCorr off the TPU; that is a backend switch, not semantics)."""
    f = torch.zeros(1, 4, 6, 8)
    assert isinstance(tcorr.make_corr(f, f, 2, materialize_threshold=24), tcorr.DenseCorrPyramid)
    assert isinstance(tcorr.make_corr(f, f, 2, materialize_threshold=23), tcorr.FlashCorr2)
    assert tcorr.MATERIALIZE_THRESHOLD == 168 * 168
    big = torch.zeros(1, 169, 168, 2)
    assert isinstance(tcorr.make_corr(big, big, 2), tcorr.FlashCorr2)
    edge = torch.zeros(1, 168, 168, 2)
    assert isinstance(tcorr.make_corr(edge, edge, 1), tcorr.DenseCorrPyramid)


def test_flash_auto_split_follows_dense_budget():
    f = torch.zeros(1, 8, 8, 4)
    assert tcorr.FlashCorr.build(f, f, 3).dense.level_offset == 1
    assert len(tcorr.FlashCorr.build(f, f, 3).flash_pyr) == 1
    all_flash = tcorr.FlashCorr.build(f, f, 3, dense_budget=0)
    assert all_flash.dense is None and len(all_flash.flash_pyr) == 3


# ---- the four patch wrappers against their JAX kernels ------------------


def patch_indices(level: int, radius: int, sigma: float = 12.0):
    """Clamped rr, cc [B, H*W, side] of one level, from the JAX geometry."""
    flow = jnp.asarray(flows(sigma))
    ys, xs = jnp.mgrid[0:H, 0:W]
    bx = (xs.astype(jnp.float32)[None] + flow[..., 0]).reshape(B, H * W)
    by = (ys.astype(jnp.float32)[None] + flow[..., 1]).reshape(B, H * W)
    lh, lw = jcorr.pyramid_level_dims(H, W, level)
    idx = jcorr._radius_patch_indices(bx, by, level, lh, lw, radius)
    return idx.rr, idx.cc, lh, lw


def flat_level(pyr, lvl: int) -> np.ndarray:
    """One grouped JAX level [N, nh_a, gw_a] -> flat [N, lh, lw] f32 numpy."""
    lh, lw = jcorr.pyramid_level_dims(pyr.h2, pyr.w2, lvl)
    g = pyr.groups[lvl]
    nh = -(-lh // g)
    v = np.asarray(pyr.pyramid[lvl].astype(jnp.float32))[:, :nh, : g * lw]
    return np.ascontiguousarray(v.reshape(v.shape[0], nh * g, lw)[:, :lh])


def as_int32(x):
    return torch.from_numpy(np.asarray(x)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def jax_corr_patch(which: str, dt: str, level: int, radius: int):
    """(JAX kernel's patch in interpret mode as f32 numpy, pooled f2 level as
    f32 numpy, rr, cc) for one (kernel, dtype, level, radius)."""
    f1, f2 = features(dt)
    rr, cc, lh, lw = patch_indices(level, radius)
    jf2 = to_jax(f2, dt)
    for _ in range(level):
        jf2 = jcorr._avg_pool_features(jf2)
    side = 2 * radius + 2
    jf1 = to_jax(f1, dt).reshape(B, H * W, C)
    if which == "flash2":
        ref = jax_flash2_patch_level(jf1, pack_f2_level(jf2), rr, cc, lh=lh, lw=lw, side=side, interpret=True)
    else:
        ref = jax_flash_patch_level(jf1, pad_f2_level(jf2), rr, cc, lh=lh, lw=lw, side=side, interpret=True)
    return np.asarray(ref.astype(jnp.float32)), np.asarray(jf2.astype(jnp.float32)), rr, cc


@pytest.mark.parametrize("grid_w", [None, W], ids=["one_row", "grid"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["flash2", "flash"])
@pytest.mark.parametrize("level,radius", [(0, 4), (1, 3)])
def test_corr_patch_wrappers_match_jax_kernels(which, dt, level, radius, grid_w):
    """Each wrapper, with and without the query grid's width, against its
    JAX kernel in interpret mode."""
    f1, _ = features(dt)
    ref, f2l, rr, cc = jax_corr_patch(which, dt, level, radius)
    side = 2 * radius + 2
    fn = flash2_patch_level if which == "flash2" else flash_patch_level
    got = fn(to_torch(f1, dt).reshape(B, H * W, C), to_torch(f2l, dt), as_int32(rr), as_int32(cc), grid_w=grid_w)
    assert got.dtype == TDT[dt] and tuple(got.shape) == (B, H * W, side, side)
    # f32 sums of 32 products in another order; bf16: the same f32 sum
    # rounded once, one ulp apart where it sits on a rounding boundary.
    tol = 1e-5 if dt == "f32" else 2.0**-7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("level,radius", [(0, 4), (2, 3)])
def test_dense_patch_level_matches_jax_kernel(dt, level, radius):
    """Exact volume entries: bitwise equal on the same volume values."""
    f1, f2 = features(dt)
    pyr = jcorr.DenseCorrPyramid.build(to_jax(f1, dt), to_jax(f2, dt), LEVELS)
    rr, cc, lh, lw = patch_indices(level, radius)
    side = 2 * radius + 2
    ref = jax_dense_patch_level(pyr.pyramid[level], rr, cc, lh=lh, lw=lw, g=pyr.groups[level],
                                side=side, interpret=True)
    vol = to_torch(flat_level(pyr, level), dt)
    got = dense_patch_level(vol, as_int32(rr), as_int32(cc))
    assert got.dtype == TDT[dt]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("level,radius", [(0, 4), (2, 3)])
def test_band_patch_level_matches_jax_kernel(dt, level, radius):
    """Exact volume entries from the plane-row-outer layout: bitwise equal
    on the JAX pyramid's values with its row, query and lane padding cut."""
    f1, f2 = features(dt)
    pyr = jcorr.BandCorrPyramid.build(to_jax(f1, dt), to_jax(f2, dt), LEVELS)
    rr, cc, lh, lw = patch_indices(level, radius)
    side = 2 * radius + 2
    jvol = pyr.pyramid[level]
    ref = jax_band_patch_level(jvol, rr, cc, lh=lh, lw=lw, side=side, interpret=True)
    vol = to_torch(np.asarray(jvol.astype(jnp.float32))[:, :lh, : H * W, :lw], dt).contiguous()
    got = band_patch_level(vol, as_int32(rr), as_int32(cc))
    assert got.dtype == TDT[dt]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_band_build_matches_jax(dt):
    f1, f2 = features(dt)
    ref = jcorr.BandCorrPyramid.build(to_jax(f1, dt), to_jax(f2, dt), LEVELS)
    got = tcorr.BandCorrPyramid.build(to_torch(f1, dt), to_torch(f2, dt), LEVELS)
    for lvl, (jvol, vol) in enumerate(zip(ref.pyramid, got.pyramid)):
        lh, lw = jcorr.pyramid_level_dims(H, W, lvl)
        assert tuple(vol.shape) == (B, lh, H * W, lw) and vol.dtype == TDT[dt]
        cut = np.asarray(jvol.astype(jnp.float32))[:, :lh, : H * W, :lw]
        tol = 1e-5 if dt == "f32" else 2.0**-7
        np.testing.assert_allclose(vol.float().numpy(), cut, rtol=tol, atol=tol)


def test_corr_patch_plain_chunks_agree():
    """Query chunking (a ragged last chunk included) changes no value."""
    g = torch.Generator().manual_seed(0)
    f1 = torch.randn(2, 37, 16, generator=g)
    f2 = torch.randn(2, 5, 7, 16, generator=g)
    rr = torch.randint(0, 5, (2, 37, 8), generator=g, dtype=torch.int32)
    cc = torch.randint(0, 7, (2, 37, 8), generator=g, dtype=torch.int32)
    whole = flash2_patch_level_plain(f1, f2, rr, cc)
    small = flash2_patch_level_plain(f1, f2, rr, cc, budget=2 * 64 * 16 * 4 * 5)   # 5-query chunks
    torch.testing.assert_close(small, whole, rtol=0, atol=0)
    want = torch.einsum("bqc,bqijc->bqij", f1, f2[torch.arange(2)[:, None, None, None],
                        rr.long()[:, :, :, None], cc.long()[:, :, None, :]]) / 4.0
    torch.testing.assert_close(whole, want, rtol=1e-5, atol=1e-5)


def test_patch_wrappers_reject_bad_inputs():
    f1, f2 = torch.zeros(1, 6, 8), torch.zeros(1, 2, 3, 8)
    rr = cc = torch.zeros(1, 6, 4, dtype=torch.int32)
    for fn in (flash2_patch_level, flash_patch_level):
        with pytest.raises(ValueError):
            fn(f1, f2, rr.long(), cc.long())                       # indices not int32
        with pytest.raises(ValueError):
            fn(f1, f2.to(torch.bfloat16), rr, cc)                  # mixed dtypes
        with pytest.raises(ValueError):
            fn(f1, torch.zeros(1, 2, 3, 4), rr, cc)                # C mismatch
        with pytest.raises(ValueError):
            fn(f1, f2, torch.zeros(1, 6, 17, dtype=torch.int32), torch.zeros(1, 6, 17, dtype=torch.int32))
    with pytest.raises(ValueError):
        dense_patch_level(torch.zeros(5, 2, 3), rr, cc)            # N != B*Nq
    with pytest.raises(ValueError):
        dense_patch_level(torch.zeros(6, 2, 3, dtype=torch.float16), rr, cc)
    with pytest.raises(ValueError):
        band_patch_level(torch.zeros(1, 2, 5, 3), rr, cc)          # Nq mismatch
    with pytest.raises(ValueError):
        dense_lookup([torch.zeros(12, 3, 4)], torch.zeros(1, 3, 4, 2), 1, level_offset=-1)


@pytest.mark.parametrize("grid_w", [5, 7, 0, -W, H * W + 1, 24.0])
@pytest.mark.parametrize("fn", [flash2_patch_level, flash_patch_level], ids=["flash2", "flash"])
def test_corr_patch_wrappers_refuse_bad_grid_width(fn, grid_w):
    """A grid width must be a positive int that divides Nq = 384."""
    f1, f2 = torch.zeros(B, H * W, 8), torch.zeros(B, 3, 4, 8)
    rr = cc = torch.zeros(B, H * W, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="grid_w"):
        fn(f1, f2, rr, cc, grid_w=grid_w)
    for ok in (None, 1, W, H, H * W):
        assert tuple(fn(f1, f2, rr, cc, grid_w=ok).shape) == (B, H * W, 4, 4)


@pytest.mark.parametrize("name,attr", [("flash2", "flash2_patch_level"), ("flash_all", "flash_patch_level")])
def test_recomputed_lookup_passes_grid_width(monkeypatch, name, attr):
    """FlashCorr2 and FlashCorr hand each level's kernel call fmap1's grid
    width, and their lookups stay the JAX classes' (the bf16 patch through
    the same plain version)."""
    seen = []
    kernel = getattr(tcorr, attr)

    def spy(f1, f2l, rr, cc, **kw):
        seen.append((tuple(f1.shape), kw))
        return kernel(f1, f2l, rr, cc, **kw)

    monkeypatch.setattr(tcorr, attr, spy)
    flow = flows(6.0)
    f1, f2 = (to_torch(x, "bf16") for x in features("bf16"))
    got = CLASSES[name][1](f1, f2).lookup(torch.from_numpy(flow), 4).numpy()
    assert seen == [((B, H * W, C), {"grid_w": W})] * LEVELS
    ref = np.asarray(jax_lookup(name, "bf16", 4)(jnp.asarray(flow)))
    assert np.abs(got - ref).max() <= BF16_TOL * max(1.0, float(np.abs(ref).max()))


def brute_force_boxes(rr: np.ndarray, cc: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """Pixels of the bounding box of the union of every patch index pair
    (rr[q, i], cc[q, j]) over each 4 x 8 tile's queries on the grid."""
    b = rr.shape[0]
    th, tw = tflashcorr2.TILE_ROWS, tflashcorr2.TILE_COLS
    out = np.zeros((b, -(-gh // th), -(-gw // tw)), np.int64)
    for bi in range(b):
        for ty in range(out.shape[1]):
            for tx in range(out.shape[2]):
                pix = {(r, c) for y in range(ty * th, min(gh, ty * th + th))
                       for x in range(tx * tw, min(gw, tx * tw + tw))
                       for r in rr[bi, y * gw + x] for c in cc[bi, y * gw + x]}
                ys, xs = [p[0] for p in pix], [p[1] for p in pix]
                out[bi, ty, tx] = (max(ys) - min(ys) + 1) * (max(xs) - min(xs) + 1)
    return out


@pytest.mark.parametrize("sigma", [0.5, 3.0, 30.0], ids=["small", "moderate", "edges"])
@pytest.mark.parametrize("gh,gw,level", [(13, 17, 0), (13, 17, 2), (5, 9, 1), (1, 23, 0), (4, 8, 0), (9, 40, 0)])
def test_tile_path_rule_matches_brute_force(gh, gw, level, sigma):
    """The host copy of the kernel's path rule (tile_boxes, tensor_path_tiles)
    against the union of each tile's patch indices, on ragged grids and with
    patches clamped at the plane's edges."""
    from tpuflow_torch.core.corr import _base_coords, _radius_patch_indices, pyramid_level_dims

    rng = np.random.default_rng(gh * 100 + gw + level)
    flow = torch.from_numpy(rng.normal(0, sigma, (2, gh, gw, 2)).astype(np.float32))
    lh, lw = pyramid_level_dims(gh, gw, level)
    idx = _radius_patch_indices(*_base_coords(flow), level, lh, lw, 3)
    got = tflashcorr2.tile_boxes(idx.rr, idx.cc, gw, lh, lw)
    want = brute_force_boxes(idx.rr.numpy(), idx.cc.numpy(), gh, gw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() <= lh * lw
    np.testing.assert_array_equal(tflashcorr2.tensor_path_tiles(idx.rr, idx.cc, gw, lh, lw).numpy(),
                                  want <= tflashcorr2.MAX_BOX_PIXELS)


def test_tile_path_rule_takes_large_boxes_off_the_tensor_path():
    """Independent +-40-cell flows give boxes beyond MAX_BOX_PIXELS at level
    0 of a 64 x 96 grid; zero flow gives the 4 x 8 tile's 11 x 15 box."""
    from tpuflow_torch.core.corr import _base_coords, _radius_patch_indices

    gh, gw = 64, 96
    flow = torch.from_numpy(np.random.default_rng(1).uniform(-40, 40, (1, gh, gw, 2)).astype(np.float32))
    idx = _radius_patch_indices(*_base_coords(flow), 0, gh, gw, 4)
    assert not tflashcorr2.tensor_path_tiles(idx.rr, idx.cc, gw, gh, gw).any()
    idx = _radius_patch_indices(*_base_coords(torch.zeros(1, gh, gw, 2)), 0, gh, gw, 4)
    boxes = tflashcorr2.tile_boxes(idx.rr, idx.cc, gw, gh, gw)
    assert boxes[0, 5, 5].item() == (4 + 9) * (8 + 9)
    assert tflashcorr2.tensor_path_tiles(idx.rr, idx.cc, gw, gh, gw).all()


@pytest.mark.parametrize("dtype,c,want", [(torch.bfloat16, 256, True), (torch.bfloat16, 32, True),
                                          (torch.bfloat16, 48, True), (torch.bfloat16, 40, False),
                                          (torch.bfloat16, 512, False), (torch.float32, 256, False)])
def test_takes_tiles(dtype, c, want):
    """bf16 with whole 16-channel steps up to 256 channels runs tiles; f32
    and other widths take the per-query path."""
    assert tflashcorr2.takes_tiles(dtype, c) is want


# ---- K4/K6's all-levels entries -----------------------------------------

LAYOUTS = {"flat": (tdense.dense_patch_levels, tdense.dense_patch_level_plain),
           "band": (tband.band_patch_levels, tband.band_patch_level_plain)}


def ragged_levels(layout: str, dt: str, radius: int, seed: int = 5):
    """Volumes of 3 levels (planes 13x17, 6x8, 3x4 up to radius 4) for 3 x 7x11 = 231
    queries and each level's clamped rr, cc from flows of up to 1.5x the
    plane, numpy-drawn; asserts that patches straddle every edge of level 0
    and that some queries' columns are clamped and some not."""
    rng = np.random.default_rng(seed + radius)
    b, h, w = 3, 7, 11
    side = 2 * radius + 2
    # Level 0 is 13x17, or wider than a patch; targets uniform over it and
    # a patch beyond it.
    lh0, lw0 = max(13, side + 9), max(17, side + 11)
    ys, xs = np.mgrid[0:h, 0:w]
    tx = rng.uniform(-side - 1.0, lw0 + 1.0, (b, h, w))
    ty = rng.uniform(-side - 1.0, lh0 + 1.0, (b, h, w))
    flow = torch.from_numpy(np.stack([tx - xs, ty - ys], -1).astype(np.float32))
    bx, by = tcorr._base_coords(flow)
    vols, rrs, ccs = [], [], []
    for lvl in range(3):
        lh, lw = tcorr.pyramid_level_dims(lh0, lw0, lvl)
        v = torch.from_numpy(rng.standard_normal((b * h * w, lh, lw)).astype(np.float32)).to(TDT[dt])
        if layout == "band":
            v = v.reshape(b, h * w, lh, lw).transpose(1, 2).contiguous()
        idx = tcorr._radius_patch_indices(bx, by, lvl, lh, lw, radius)
        vols.append(v)
        rrs.append(idx.rr)
        ccs.append(idx.cc)
        if lvl == 0:
            for raw, n in ((idx.xraw, lw), (idx.yraw, lh)):
                lo = raw[..., 0]
                assert ((lo < 0) & (lo + side > 0)).any() and ((lo < n) & (lo + side > n)).any()
            contiguous = idx.cc[..., -1] - idx.cc[..., 0] == side - 1
            assert contiguous.any() and not contiguous.all()
    return vols, rrs, ccs


@pytest.mark.parametrize("radius", [0, 1, 4, 14])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_patch_levels_match_plain_per_level(layout, dt, radius):
    """The all-levels entry gives each level's plain patch, bit for bit, on
    ragged shapes with patches across every plane edge; the one-level
    wrapper gives the same."""
    levels_fn, plain = LAYOUTS[layout]
    one = tdense.dense_patch_level if layout == "flat" else tband.band_patch_level
    vols, rrs, ccs = ragged_levels(layout, dt, radius)
    got = levels_fn(vols, rrs, ccs)
    assert len(got) == len(vols)
    for g, v, rr, cc in zip(got, vols, rrs, ccs):
        ref = plain(v, rr, cc)
        assert g.dtype == TDT[dt] and tuple(g.shape) == (3, 77, 2 * radius + 2, 2 * radius + 2)
        assert torch.equal(g, ref) and torch.equal(one(v, rr, cc), ref)


def _bad_level_lists(layout: str):
    """(what, volumes, rrs, ccs) that the all-levels wrappers refuse."""
    vols, rrs, ccs = ragged_levels(layout, "f32", 1)
    meta = vols[1].to("meta")
    return {
        "no_levels": ([], [], []),
        "nine_levels": (vols * 3, rrs * 3, ccs * 3),
        "fewer_rr": (vols, rrs[:2], ccs),
        "fewer_cc": (vols, rrs, ccs[:1]),
        "mixed_dtype": ([vols[0], vols[1].to(torch.bfloat16), vols[2]], rrs, ccs),
        "mixed_device": ([vols[0], meta, vols[2]], rrs, ccs),
        "float16": ([v.to(torch.float16) for v in vols], rrs, ccs),
        "rr_shapes_differ": (vols, [rrs[0], rrs[1][:, :-1].contiguous(), rrs[2]], [ccs[0], ccs[1][:, :-1].contiguous(), ccs[2]]),
        "odd_side": (vols, [r[..., :3].contiguous() for r in rrs], [c[..., :3].contiguous() for c in ccs]),
        "side_above_30": (vols, [r.repeat(1, 1, 8) for r in rrs], [c.repeat(1, 1, 8) for c in ccs]),
        "other_layout": ([v.reshape(3, -1, *v.shape[2:]) if layout == "flat" else v.reshape(-1, *v.shape[3:]).contiguous()
                          for v in vols], rrs, ccs),
    }


@pytest.mark.parametrize("what", list(_bad_level_lists("flat")))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_patch_levels_reject_bad_level_lists(layout, what):
    vols, rrs, ccs = _bad_level_lists(layout)[what]
    with pytest.raises(ValueError):
        LAYOUTS[layout][0](vols, rrs, ccs)


@pytest.mark.parametrize("name,attr", [("dense_patch", "dense_patch_levels"), ("band", "band_patch_levels")])
def test_patch_lookup_makes_one_call_for_all_levels(monkeypatch, name, attr):
    """A 'patch' or 'band' lookup hands every level to one call of the
    all-levels entry (one launch on the card), and stays the JAX class's
    lookup."""
    seen = []
    fn = getattr(tcorr, attr)

    def spy(vols, rrs, ccs):
        seen.append((len(vols), len(rrs), len(ccs)))
        return fn(vols, rrs, ccs)

    monkeypatch.setattr(tcorr, attr, spy)
    flow = flows(30.0)
    f1, f2 = (to_torch(x, "bf16") for x in features("bf16"))
    kw = {"impl": "patch"} if name == "dense_patch" else {}
    got = CLASSES[name][1](f1, f2).lookup(torch.from_numpy(flow), 4, **kw).numpy()
    assert seen == [(LEVELS, LEVELS, LEVELS)]
    ref = np.asarray(jax_lookup(name, "bf16", 4)(jnp.asarray(flow)))
    assert np.abs(got - ref).max() <= BF16_TOL * max(1.0, float(np.abs(ref).max()))
