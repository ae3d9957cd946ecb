"""The port's stride-1 and tile batching against the JAX engine on the CPU:
`compute_flow_tiled(tile_batch=)` and `compute_flows_tiled_stride1(
window_batch=)`, also against the JAX engine's pair-cached loop, which the
port does not have.

Weights are one random flax MOFNet param tree (Twins, 2 levels, radius 2,
2 iterations), drawn with numpy from a seed and carried into the port by
`state_dict_from_jax`; both engines keep f32 volumes.  Frames are 72 high
and tiles 72x88 at tile_size=96, as in tests/test_torch_port_model.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.core.mofnet import MOFNet as JaxMOFNet
from tpuflow.runtime.convert import unflatten_params
from tests.test_torch_port_model import CFG, H, W, one_torch_thread, random_flax_params  # noqa: F401 (autouse)
from tests.jax_learned_start import jax_learned_start  # noqa: F401 (autouse)

from tpuflow_torch.runtime.convert import state_dict_from_jax


@pytest.fixture(scope="module")
def models():
    """The JAX MOFNet (plain paths) and one random flax param tree for it."""
    jmodel = JaxMOFNet(
        encoder="twins", dtype=jnp.float32, corr_dtype=jnp.float32,
        dense_lookup="xla", gma_impl="xla", **CFG,
    )
    flat = random_flax_params(jmodel, seed=0)
    return jmodel, unflatten_params(flat), flat


@pytest.fixture(scope="module")
def tiled_engines(models):
    """The JAX FlowEngine and the port's on the same converted weights, f32
    volumes on both sides, and a clip of 6 frames of 72x176 (two 72x88
    tiles at tile_size=96)."""
    from tpuflow.config import ModelConfig as JaxModelConfig
    from tpuflow.runtime.engine import FlowEngine as JaxFlowEngine
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine

    _, params, flat = models
    jeng = JaxFlowEngine(JaxModelConfig(**CFG), params=params, dtype=jnp.float32)
    jeng.model = jeng.model.clone(corr_dtype=jnp.float32)
    jeng.load_model()
    eng = FlowEngine(ModelConfig(**CFG), params=state_dict_from_jax(flat), device="cpu")
    eng.model.corr_dtype = torch.float32
    assert eng.load_model() == "preloaded"
    clip = (np.random.default_rng(11).random((6, H, 2 * W, 3)) * 255).astype(np.uint8)
    return jeng, eng, clip


def test_tile_batch_matches_jax(tiled_engines):
    """compute_flow_tiled on 72x264 frames at tile_size=96: one shape group
    of three 72x88 tiles, run in chunks of tile_batch 1 (1+1+1), 2 (2+1) and
    4 (one chunk of 3), against the JAX engine's tile_batch=4."""
    jeng, eng, _ = tiled_engines
    frames = (np.random.default_rng(12).random((5, H, 3 * W, 3)) * 255).astype(np.uint8)
    _, groups = eng._tiling(H, 3 * W, 96)
    assert [len(idxs) for idxs in groups.values()] == [3]
    ref = jeng.compute_flow_tiled(frames, 2, tile_size=96, tile_batch=4)
    got = {tb: eng.compute_flow_tiled(frames, 2, tile_size=96, tile_batch=tb) for tb in (1, 2, 4)}
    for tb, flow in got.items():
        assert flow.shape == (H, 3 * W, 2) and np.isfinite(flow).all()
        np.testing.assert_allclose(flow, ref, rtol=2e-3, atol=2e-3, err_msg=f"tile_batch={tb}")
        # Chunks hold independent tiles, but another batch size sums the
        # CPU's convolutions in another order (about 1e-5 of the flow),
        # which two iterations of feedback amplify.
        np.testing.assert_allclose(flow, got[4], rtol=1e-4, atol=3e-4, err_msg=f"tile_batch={tb}")


def test_window_batch_matches_jax(tiled_engines):
    """compute_flows_tiled_stride1(window_batch=2) on 6 frames: three batches
    of two windows stacked window-major on the tile batch, pipelined one
    batch deep, against the JAX engine's window_batch=2 and the port's
    window_batch=1."""
    jeng, eng, clip = tiled_engines
    ref = jeng.compute_flows_tiled_stride1(clip, tile_size=96, window_batch=2)
    seen = []
    got = eng.compute_flows_tiled_stride1(
        clip, tile_size=96, window_batch=2, progress_cb=lambda i, f: seen.append(i)
    )
    assert seen == list(range(len(clip)))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    one = eng.compute_flows_tiled_stride1(clip, tile_size=96, window_batch=1)
    # f32 both: the CPU's matmuls and convolutions sum a batch of 4 rows in
    # another order than one of 2, so within 1e-5 of the largest |flow|
    # (33 px here) rather than bit for bit.
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-5 * np.abs(one).max())


def test_pairs_loop_matches_trio_and_jax(tiled_engines, monkeypatch):
    """The port has one stride-1 loop: under TPUFLOW_STRIDE1=pairs it gives
    exactly what it gives without the variable, and the model has no
    per-pair refinement.  The JAX engine still runs its pair-cached loop
    under the variable (each frame pair's correlation built once), a second
    formulation of the same flows, which the port's flows match."""
    jeng, eng, clip = tiled_engines
    trio = eng.compute_flows_tiled_stride1(clip, tile_size=96)
    monkeypatch.setenv("TPUFLOW_STRIDE1", "pairs")
    np.testing.assert_array_equal(eng.compute_flows_tiled_stride1(clip, tile_size=96), trio)
    assert not hasattr(eng.model, "refine_pairs")
    ref = jeng.compute_flows_tiled_stride1(clip, tile_size=96)
    np.testing.assert_allclose(trio, ref, rtol=2e-3, atol=2e-3)
