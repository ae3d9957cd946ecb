"""The parts of core/corr.py that no model path reads, against the JAX
package on the CPU: CorrPyramid.lookup_span and lookup_rows, the
border='clamp' lookups, and a dense lookup's `impl`, which the JAX
package's environment override does not reach in the port.

f32 features and volumes on both sides.  Tolerances: the gather
formulations equal the port's own lookup bit for bit and the JAX
package's within 1e-5 (the JAX one-hot contractions); other formulations
within 1e-4, as tests/test_models.py holds the JAX ones to each other
(deep levels pooled from features or from the volume, another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.core.corr import CorrPyramid as JaxCorrPyramid
from tpuflow.core.corr import DenseCorrPyramid as JaxDense
from tpuflow.core.corr import OnTheFlyCorr as JaxOnTheFly
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

from tpuflow_torch.core import corr

LEVELS = 3


@pytest.fixture(scope="module")
def maps():
    """tests/test_models.py:92's draw: [2, 16, 24, 32] features, flows of
    N(0, 6) px, so that windows cross every plane edge."""
    rng = np.random.default_rng(11)
    f1 = rng.normal(size=(2, 16, 24, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 16, 24, 32)).astype(np.float32)
    flow = rng.normal(0, 6, size=(2, 16, 24, 2)).astype(np.float32)
    return f1, f2, flow


def port_pyramid(maps):
    f1, f2, _ = maps
    return corr.CorrPyramid.build(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)


def jax_pyramid(maps):
    f1, f2, _ = maps
    return JaxCorrPyramid.build(jnp.asarray(f1), jnp.asarray(f2), LEVELS)


@pytest.mark.parametrize("border", ["zeros", "clamp"])
@pytest.mark.parametrize("method", ["lookup_span", "lookup_rows"])
@pytest.mark.parametrize("radius", [3, 8])
def test_gather_formulations_match_jax(maps, method, radius, border):
    """lookup_span and lookup_rows against the JAX package's, and against
    the port's lookup: equal, except lookup_span at radius 8, whose 18-wide
    patches exceed its 16-wide spans (a column the span lacks reads 0 on
    both sides)."""
    flow = maps[2]
    got = getattr(port_pyramid(maps), method)(torch.from_numpy(flow), radius, border)
    ref = np.asarray(getattr(jax_pyramid(maps), method)(jnp.asarray(flow), radius, border))
    assert got.shape == ref.shape == (2, 16, 24, LEVELS * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    same = port_pyramid(maps).lookup(torch.from_numpy(flow), radius, border)
    assert torch.equal(got, same) == (method == "lookup_rows" or radius == 3)


def _clamp_lookups(maps):
    """Every port formulation's border='clamp' lookup at radius 3."""
    f1, f2, flow = (torch.from_numpy(a) for a in maps)
    out = {}
    for impl in ("gather", "direct", "flash", "flash2", "band"):
        out[impl] = corr.make_corr(f1, f2, LEVELS, impl=impl).lookup(flow, 3, border="clamp")
    dense = corr.make_corr(f1, f2, LEVELS, impl="dense")
    for mode in ("auto", "patch", "xla"):
        out[f"dense-{mode}"] = dense.lookup(flow, 3, impl=mode, border="clamp")
    return out


@pytest.fixture(scope="module")
def clamp_lookups(maps):
    return _clamp_lookups(maps)


@pytest.mark.parametrize("impl", ["gather", "direct", "flash", "flash2", "band", "dense-auto", "dense-patch",
                                  "dense-xla"])
def test_clamp_lookups_match_jax(maps, clamp_lookups, impl):
    """border='clamp' through every port lookup against the JAX package's
    CorrPyramid clamp lookup (and its DenseCorrPyramid and OnTheFlyCorr
    ones where the port's formulation is theirs); a dense 'auto' clamp
    lookup takes the exact-patch path, as the JAX package's drops its
    fused kernel for a clamp border."""
    f1, f2, flow = maps
    got = clamp_lookups[impl].numpy()
    ref = np.asarray(jax_pyramid(maps).lookup(jnp.asarray(flow), 3, "clamp"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    if impl.startswith("dense"):
        jd = JaxDense.build(jnp.asarray(f1), jnp.asarray(f2), LEVELS)
        np.testing.assert_allclose(got, np.asarray(jd.lookup(jnp.asarray(flow), 3, "clamp", impl="xla")),
                                   rtol=1e-5, atol=1e-5)
    if impl == "direct":
        jo = JaxOnTheFly.build(jnp.asarray(f1), jnp.asarray(f2), LEVELS)
        np.testing.assert_allclose(got, np.asarray(jo.lookup(jnp.asarray(flow), 3, "clamp")), rtol=1e-5,
                                   atol=1e-5)
    zeros = corr.make_corr(*(torch.from_numpy(a) for a in maps[:2]), LEVELS,
                           impl=impl.split("-")[0]).lookup
    kw = {"impl": impl.split("-")[1]} if impl.startswith("dense") else {}
    assert not np.array_equal(got, zeros(torch.from_numpy(flow), 3, **kw).numpy())
    if impl in ("dense-auto", "dense-patch"):
        np.testing.assert_array_equal(got, clamp_lookups["dense-xla"].numpy())


def test_unknown_border_raises(maps):
    f1, f2, flow = (torch.from_numpy(a) for a in maps)
    for impl in ("gather", "dense", "direct", "flash2"):
        with pytest.raises(ValueError, match="border"):
            corr.make_corr(f1, f2, LEVELS, impl=impl).lookup(flow, 3, border="reflect")


@pytest.mark.parametrize("env", ["pallas", "interpret", "patch", "xla", "auto"])
def test_dense_lookup_env_override(maps, monkeypatch, env):
    """A dense lookup's mode is its `impl` argument alone: with the JAX
    package's TPUFLOW_DENSE_LOOKUP set to any of its values, every `impl`
    gives what it gives without the variable, and an unknown `impl` still
    raises.  The 'xla' lookup stays the JAX package's XLA formulation."""
    f1, f2, flow = (torch.from_numpy(a) for a in maps)
    dense = corr.make_corr(f1, f2, LEVELS, impl="dense")
    want = {impl: dense.lookup(flow, 3, impl=impl) for impl in ("auto", "patch", "xla")}
    monkeypatch.setenv("TPUFLOW_DENSE_LOOKUP", env)
    for impl, out in want.items():
        assert torch.equal(dense.lookup(flow, 3, impl=impl), out), impl
    assert not torch.equal(want["auto"], want["patch"])    # f32 bilinear against the volume's dtype's
    if env == "xla":
        jd = JaxDense.build(*(jnp.asarray(a) for a in maps[:2]), LEVELS)
        np.testing.assert_allclose(want["xla"].numpy(), np.asarray(jd.lookup(jnp.asarray(maps[2]), 3, impl="xla")),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="onehot"):
        dense.lookup(flow, 3, impl="onehot")
