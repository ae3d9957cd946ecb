"""The port's flow-correction engine (tpuflow_torch.tools.correction)
against the JAX package's, on the CPU, from numpy inputs drawn from seeds.

Tolerances: `extract_regions` bit for bit (a gather); `phase_correlate_batch`
shifts within 1e-4 px and confidences within 1e-5, on textured regions
(smoothed noise: where a region is flat or wholly outside the frame the
response has near-ties, which pocketfft and ducc break differently);
`ncc_match_batch` within 1e-5 (the window sums of 0-255 pixels cancel in
`ssq - ssum**2 / area`); the passes with equal integer targets, flows within
1e-4 and similarities within 1e-6; `correct_frame` and
`correct_cache_range` with equal error counts and flows within 1e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from tpuflow.pipeline.cache import FlowFileHandler as JaxFlowFileHandler
from tpuflow.tools import correction as jcorr
from tpuflow_torch.pipeline.cache import FlowFileHandler
from tpuflow_torch.tools import correction as corr

SHIFT_TOL = 1e-4
CONF_TOL = 1e-5
NCC_TOL = 1e-5
FLOW_TOL = 1e-4
SIM_TOL = 1e-6


def smooth_noise(rng, shape, sigma=1.5, scale=60.0, offset=128.0):
    """Textured noise: white noise blurred by a separable Gaussian."""
    x = rng.normal(size=shape)
    k = np.exp(-0.5 * (np.arange(-4, 5) / sigma) ** 2)
    k /= k.sum()
    for axis in (0, 1):
        x = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), axis, x)
    return (offset + scale * x / x.std()).astype(np.float32)


def translated_pair(seed, h=96, w=128, dx=5, dy=3):
    """A textured uint8 frame and the same frame with its content moved by
    (-dx, -dy): the flow (dx, dy) maps frame 1 to frame 2 (target = source -
    flow)."""
    rng = np.random.default_rng(seed)
    f1 = np.stack([smooth_noise(rng, (h, w), sigma=1.0) for _ in range(3)], -1)
    f1 = np.clip(f1, 0, 255).astype(np.uint8)
    f2 = np.roll(np.roll(f1, -dy, axis=0), -dx, axis=1)
    return f1, f2


def port(d):
    return {k: v.numpy() for k, v in d.items()}


def jax_(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_pass_equal(got, ref, integer_targets):
    if integer_targets:
        np.testing.assert_array_equal(got["target"], ref["target"])
    else:
        np.testing.assert_array_equal(np.trunc(got["target"]), np.trunc(ref["target"]))
    np.testing.assert_allclose(got["flow"], ref["flow"], rtol=0, atol=FLOW_TOL)
    np.testing.assert_allclose(got["similarity"], ref["similarity"], rtol=0, atol=SIM_TOL)


def test_spiral_offsets_match_jax():
    for w, h in ((6, 6), (22, 22), (5, 8)):
        np.testing.assert_array_equal(corr.generate_spiral_offsets(w, h), jcorr.generate_spiral_offsets(w, h))
    assert len(corr.generate_spiral_offsets(22, 22)) == 484


@pytest.mark.parametrize("channels", [0, 3])
def test_extract_regions_bitwise(channels):
    """Centers inside, on and beyond every edge, fractional, NaN and
    infinite (XLA's conversion: NaN to 0, saturate; then int32 arithmetic)."""
    rng = np.random.default_rng(1)
    shape = (40, 50, channels) if channels else (40, 50)
    img = rng.integers(0, 255, shape).astype(np.float32)
    cx = np.array([25, 0, -3.7, 49.9, np.nan, 1e10, -1e10, 60.2, 4.5], np.float32)
    cy = np.array([20, 0, 39.5, -2.2, 5, 3, np.inf, -np.inf, 44.0], np.float32)
    for r in (1, 5, 30):
        ref = np.asarray(jcorr.extract_regions(jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy), r))
        got = corr.extract_regions(torch.from_numpy(img), torch.from_numpy(cx), torch.from_numpy(cy), r).numpy()
        np.testing.assert_array_equal(got, ref)
    ints = np.array([[25, 20], [0, 0], [49, 39]], np.int32)
    ref = np.asarray(jcorr.extract_regions(jnp.asarray(img), jnp.asarray(ints[:, 0]), jnp.asarray(ints[:, 1]), 5))
    got = corr.extract_regions(torch.from_numpy(img), torch.from_numpy(ints[:, 0]), torch.from_numpy(ints[:, 1]), 5)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_phase_correlate_matches_jax():
    """Integer shifts either side of the Nyquist fold and a subpixel one (a
    bilinear blend of 0.3 px), on textured 100x100 regions."""
    rng = np.random.default_rng(2)
    shifts = [(3, -5), (-7, 5), (20, 13), (0, 0), (-49, 2), (1, 49), (-12, -30)]
    a = np.stack([smooth_noise(rng, (100, 100)) for _ in shifts])
    b = np.stack([np.roll(np.roll(x, dy, 0), dx, 1) for x, (dx, dy) in zip(a, shifts)])
    half = 0.7 * a[0] + 0.3 * np.roll(a[0], 1, axis=1)
    a = np.concatenate([a, a[:1]])
    b = np.concatenate([b, half[None]])
    sj, cj = jcorr.phase_correlate_batch(jnp.asarray(a), jnp.asarray(b))
    sp, cp = corr.phase_correlate_batch(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=0, atol=SHIFT_TOL)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=0, atol=CONF_TOL)
    np.testing.assert_allclose(sp.numpy()[: len(shifts)], np.asarray(shifts, np.float32), atol=1e-3)


@pytest.mark.parametrize("channels", [1, 3])
def test_ncc_match_matches_jax(channels):
    """0-255 search areas with templates cut from them plus noise, a flat
    template (zero norm: response 0) and a flat search area."""
    rng = np.random.default_rng(3 + channels)
    n, s, t = 6, 30, 10
    search = rng.integers(0, 256, (n, s, s, channels)).astype(np.float32)
    template = search[:, 5:15, 8:18, :] + rng.normal(0, 8, (n, t, t, channels)).astype(np.float32)
    template[4] = 77.0
    search[5] = 200.0
    ref = np.asarray(jcorr.ncc_match_batch(jnp.asarray(search), jnp.asarray(template)))
    got = corr.ncc_match_batch(torch.from_numpy(search), torch.from_numpy(template)).numpy()
    assert got.shape == (n, s - t + 1, s - t + 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=NCC_TOL)
    assert not got[4].any() and not got[5].any()


def test_ncc_match_single_channel_matches_cv2():
    """A known answer beside the JAX one: cv2.matchTemplate's TM_CCOEFF_NORMED
    on one channel (cv2 subtracts each channel's own mean, so only C = 1
    shares the formula)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    search = np.round(np.clip(smooth_noise(rng, (40, 40), sigma=1.0), 0, 255))
    template = search[7:19, 11:23].copy()
    want = cv2.matchTemplate(search, template, cv2.TM_CCOEFF_NORMED)
    got = corr.ncc_match_batch(torch.from_numpy(search[None, :, :, None]),
                               torch.from_numpy(template[None, :, :, None])).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return translated_pair(6)


def test_coarse_correction_matches_jax(pair):
    """Sources inside, at the edges and corners; LOD predictions right,
    wrong, fractional and pointing out of the frame."""
    f1, f2 = pair
    h, w = f1.shape[:2]
    sources = np.array([[64, 48], [30, 30], [0, 0], [w - 1, h - 1], [5, 90], [120, 3], [64, 10], [90, 70]],
                       np.int32)
    lod = np.array([[5, 3], [0, 0], [5.5, 2.7], [-3, 8], [200, -150], [5, 3], [1.25, -0.5], [7, 1]], np.float32)
    ref = jax_(jcorr.coarse_correction_batch(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(sources),
                                             jnp.asarray(lod), 16))
    got = port(corr.coarse_correction_batch(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(sources),
                                            torch.from_numpy(lod), 16))
    assert_pass_equal(got, ref, integer_targets=False)
    np.testing.assert_allclose(got["confidence"], ref["confidence"], rtol=0, atol=CONF_TOL)
    np.testing.assert_allclose(got["flow"][0], [5, 3], atol=0.05)


def test_fine_correction_matches_jax(pair):
    """Coarse targets near, far, fractional and out of the frame."""
    f1, f2 = pair
    sources = np.array([[64, 48], [30, 30], [0, 0], [127, 95], [100, 20], [10, 80]], np.int32)
    targets = np.array([[61, 44], [20.5, 31.7], [-5, -9], [122, 92], [300, -40], [np.nan, 70]], np.float32)
    kw = dict(template_radius=6, search_radius=20)
    ref = jax_(jcorr.fine_correction_batch(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(sources),
                                           jnp.asarray(targets), **kw))
    got = port(corr.fine_correction_batch(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(sources),
                                          torch.from_numpy(targets), **kw))
    assert_pass_equal(got, ref, integer_targets=True)
    np.testing.assert_allclose(got["confidence"], ref["confidence"], rtol=0, atol=NCC_TOL)
    np.testing.assert_allclose(got["flow"][0], [5, 3], atol=0)


def test_fine_spiral_takes_the_first_good_position(pair):
    """The matched center's own color is spoiled, and three spiral
    positions around it get the source's color: the rescue takes the first
    of them in spiral order, on both packages."""
    f1, f2 = pair
    f2 = f2.copy()
    sx, sy, dx, dy = 64, 48, 5, 3
    tx, ty = sx - dx, sy - dy
    f2[ty, tx] = 255 - f1[sy, sx]
    spiral = corr.generate_spiral_offsets(12, 12)
    good = [30, 9, 57]
    for k in good:
        f2[ty + spiral[k, 1], tx + spiral[k, 0]] = f1[sy, sx]
    args = (np.array([[sx, sy]], np.int32), np.array([[tx + 1, ty - 2]], np.float32))
    kw = dict(template_radius=6, search_radius=20)
    ref = jax_(jcorr.fine_correction_batch(jnp.asarray(f1), jnp.asarray(f2), *map(jnp.asarray, args), **kw))
    got = port(corr.fine_correction_batch(torch.from_numpy(f1), torch.from_numpy(f2), *map(torch.from_numpy, args),
                                          **kw))
    assert_pass_equal(got, ref, integer_targets=True)
    first = min(good)
    np.testing.assert_array_equal(got["target"][0], [tx + spiral[first, 0], ty + spiral[first, 1]])
    assert got["similarity"][0] == 1.0


def test_chunked_passes_equal_one_pass(pair, monkeypatch):
    """Chunks over the pixels compute the same function as one batch."""
    f1, f2 = pair
    rng = np.random.default_rng(8)
    sources = np.stack([rng.integers(0, 128, 11), rng.integers(0, 96, 11)], -1).astype(np.int32)
    lod = rng.normal(0, 4, (11, 2)).astype(np.float32)
    t1, t2, s, lv = torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(sources), torch.from_numpy(lod)
    one = [port(corr.coarse_correction_batch(t1, t2, s, lv, 16)),
           port(corr.fine_correction_batch(t1, t2, s, lv, template_radius=4, search_radius=12))]
    monkeypatch.setattr(corr, "CHUNK_PAIRS", 4)
    chunked = [port(corr.coarse_correction_batch(t1, t2, s, lv, 16)),
               port(corr.fine_correction_batch(t1, t2, s, lv, template_radius=4, search_radius=12))]
    for a, b in zip(one, chunked):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def static_pair(seed, h=48, w=64):
    """A textured frame that does not move, and a flow that is 0 but for
    two corrupted blocks (about 40 bad pixels: the default radii make each
    of them a 100x100x3 NCC on the CPU)."""
    f1, _ = translated_pair(seed, h, w)
    flow = np.zeros((h, w, 2), np.float32)
    flow[20:25, 20:26] = [7.0, -5.0]
    flow[30:33, 40:44] = [-3.5, 2.25]
    return f1, f1.copy(), flow


@pytest.mark.parametrize("max_pixels", [65536, 16])
def test_correct_frame_matches_jax(max_pixels):
    """Every bad pixel, and the 16 worst of them (the cap), with the flow's
    own 4x-downsampled LOD."""
    f1, f2, flow = static_pair(9)
    lod = flow[::4, ::4] * 0.25
    ref = jcorr.correct_frame(f1, f2, flow, lod, max_pixels=max_pixels)
    got = corr.correct_frame(f1, f2, flow, lod, max_pixels=max_pixels, device="cpu")
    assert (got["initial_errors"], got["final_errors"]) == (ref["initial_errors"], ref["final_errors"])
    assert got["initial_errors"] > max(16, got["final_errors"])
    assert (np.abs(got["flow"] - flow).sum(-1) > 0).sum() <= max_pixels
    np.testing.assert_allclose(got["flow"], ref["flow"], rtol=0, atol=FLOW_TOL)


def test_correct_frame_clean_flow_is_unchanged():
    f1, f2, _ = static_pair(10)
    flow = np.zeros(f1.shape[:2] + (2,), np.float32)
    ref = jcorr.correct_frame(f1, f2, flow)
    got = corr.correct_frame(f1, f2, flow, device="cpu")
    assert got == {"flow": flow, "initial_errors": 0, "final_errors": 0} == ref


def test_correct_cache_range_matches_jax(tmp_path):
    """A cache of an .npz and a .flo flow corrected by each package in a
    directory of its own: the same `_corrected/` files, flows within
    FLOW_TOL (the last frame has no successor and is skipped)."""
    f1, _, flow = static_pair(11)
    frames = [f1, f1.copy(), f1.copy()]
    flows = [flow, flow[::-1].copy(), flow]
    results = {}
    for side, handler, mod, kw in (("jax", JaxFlowFileHandler, jcorr, {}),
                                   ("port", FlowFileHandler, corr, {"device": "cpu"})):
        cache = tmp_path / side / "clip_flow_cache"
        cache.mkdir(parents=True)
        files = []
        for i, fl in enumerate(flows):
            path = cache / f"flow_frame_{i:06d}.{'flo' if i == 1 else 'npz'}"
            (handler.save_flow_flo if i == 1 else handler.save_flow_npz)(fl, str(path))
            files.append(str(path))
        res = mod.correct_cache_range(frames, files, [0, 1, 2], progress=False, **kw)
        out = cache.parent / "clip_flow_cache_corrected"
        results[side] = (res, sorted(p.name for p in out.iterdir()), out)
    (jres, jnames, jout), (pres, pnames, pout) = results["jax"], results["port"]
    assert pnames == jnames == ["flow_frame_000000.npz", "flow_frame_000001.flo"]
    for a, b in zip(pres, jres):
        assert (a["initial_errors"], a["final_errors"]) == (b["initial_errors"], b["final_errors"])
        assert Path(a["path"]).name == Path(b["path"]).name
    for name in pnames:
        load = (lambda p: FlowFileHandler.load_flow_flo(p)) if name.endswith(".flo") else (
            lambda p: FlowFileHandler.load_flow_npz(p)["flow"])
        np.testing.assert_allclose(load(str(pout / name)), load(str(jout / name)), rtol=0, atol=FLOW_TOL)


def test_correction_runs_on_the_card_by_default():
    """correct_frame's default device is the card: without one it raises."""
    f1, f2, flow = static_pair(10, 16, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            corr.correct_frame(f1, f2, flow)


def test_f32_convolutions_restores_the_flag():
    prev = torch.backends.cudnn.allow_tf32
    with corr._f32_convolutions():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == prev
