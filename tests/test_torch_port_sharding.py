"""The port's data parallelism and train step (tpuflow_torch.runtime.sharding,
FlowEngine(mesh=)) and the kernels' refusal of a gradient, on the CPU.

Meshes list the CPU more than once: each slot of the 'data' axis gets a
replica of its own, as two replicas do that share one card.

Tolerances:
- The mesh engine against the one-device port engine: bit for bit wherever
  a replica's batch equals the one-device batch (tile_batch 1, window_batch
  1, strided window_batch 1, compute_flow_batch against 4-window calls);
  otherwise within 1e-5 of the largest |flow|, since the CPU sums a batch of
  another size in another order (tests/test_torch_port_engine.py).
- The train step against the JAX package's unsharded make_train_step (f32,
  2 levels, radius 2, 2 iterations, cnn encoder, 32x32 frames): losses
  within 1e-5 relative; each gradient within 1e-3 of its tensor's largest
  |gradient| plus 1e-6 (the conv biases that an instance norm follows have
  a gradient of 0 up to rounding, about 1e-8 on both sides); parameters
  after the first AdamW step within 1e-2 lr of the JAX side's wherever its
  gradient passes that 1e-6 (the two sides round the update in other
  orders: one f32 ulp of an entry near 1 is 1.2e-3 lr, 2.4e-3 lr at most
  here; a step off by a few percent, in lr or bias correction, is not);
  parameters after 2 AdamW steps: each tensor's update (its change from the start) within
  5 % of the JAX update's L2 norm (1.5 % at most here: Adam divides by the
  gradients' own size, so their 1e-3 shows in the second step), except the
  tensors whose gradient is at rounding level, and on both sides every
  entry within the two steps' reach of 2 lr from the start (Adam turns a
  gradient at rounding level into a step of up to lr of either sign).
- shard_train_step against one step on the whole batch: losses within
  1e-6 relative, averaged gradients within 1e-5 of each tensor's largest
  plus 1e-7, SGD parameters within 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuflow.core.corr import DenseCorrPyramid as JaxDense
from tpuflow.core.mofnet import MOFNet as JaxMOFNet
from tpuflow.runtime import sharding as jsharding
from tpuflow.runtime.convert import flatten_params, unflatten_params
from tests.test_torch_port_kernels import _flat_levels
from tests.test_torch_port_model import one_torch_thread, random_flax_params  # noqa: F401 (autouse)
from tests.jax_learned_start import jax_learned_start  # noqa: F401 (autouse)

from tpuflow_torch.config import ModelConfig
from tpuflow_torch.core.corr import DenseCorrPyramid
from tpuflow_torch.core.mofnet import MOFNet
from tpuflow_torch.kernels.bandlookup import band_patch_level, band_patch_levels
from tpuflow_torch.kernels.denselookup import dense_lookup, dense_patch_level, dense_patch_levels
from tpuflow_torch.kernels.depthwise import depthwise_residual_gelu
from tpuflow_torch.kernels.flashattn import flash_attention_fwd
from tpuflow_torch.kernels.memread import memory_read
from tpuflow_torch.kernels.flashcorr import flash_patch_level
from tpuflow_torch.kernels.flashcorr2 import flash2_patch_level
from tpuflow_torch.runtime import profiling
from tpuflow_torch.runtime.convert import flax_tree_from_state_dict, state_dict_from_jax
from tpuflow_torch.runtime.engine import FlowEngine
from tpuflow_torch.runtime.sharding import (
    Mesh,
    epe_loss,
    make_mesh,
    make_train_step,
    shard_batch_forward,
    shard_sizes,
    shard_train_step,
)

CPU = torch.device("cpu")
TRAIN = dict(encoder="cnn", corr_levels=2, corr_radius=2, decoder_depth=2, feature_dim=64)
TRAIN_HW = 32
LR = 1e-4
HELD = "init_hidden_state"   # out of the train step's optimizer on both sides


def cpu_mesh(n: int) -> Mesh:
    return Mesh([CPU] * n)


# ---------------------------------------------------------------------------
# meshes and shard_batch_forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("axes", [("data",), ("data", "spatial")], ids=["1d", "2d"])
def test_make_mesh_shapes_match_jax(n, axes, monkeypatch):
    """make_mesh over the cards (cuda:0..7, counted as torch.cuda sees them;
    no card is touched) has the JAX package's shapes on its 8 CPU devices,
    and one data slot per row of 'data'."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = make_mesh(n, axes)
    assert mesh.shape == dict(jsharding.make_mesh(n, axes).shape)
    assert mesh.axis_names == axes
    slots = mesh.data_devices()
    assert len(slots) == mesh.shape["data"]
    assert all(d.type == "cuda" for d in slots) and slots[0] == torch.device("cuda", 0)
    assert make_mesh(None, axes).devices.size == 8
    with pytest.raises(ValueError):
        make_mesh(9)


def test_mesh_lists_one_device_more_than_once():
    mesh = Mesh([CPU, CPU, CPU])
    assert mesh.shape == {"data": 3} and mesh.data_devices() == [CPU] * 3
    assert shard_sizes(10, 3) == [4, 3, 3] and shard_sizes(2, 3) == [1, 1, 0]
    with pytest.raises(ValueError, match="axis names"):
        Mesh([CPU, CPU], ("data", "spatial"))


@pytest.mark.parametrize("batch", [6, 7, 2])
def test_shard_batch_forward_matches_unsharded(batch):
    """A per-row module through shard_batch_forward over 3 replicas, with
    even, ragged and short batches, against the unsharded call."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.GELU(), torch.nn.Conv2d(8, 2, 1))
    params = dict(net.named_parameters())
    fn = shard_batch_forward(lambda p, x: torch.func.functional_call(net, p, (x,)), cpu_mesh(3), 4)
    x = torch.randn(batch, 3, 9, 11)
    with torch.no_grad():
        got, ref = fn(params, x), net(x)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="dims"):
        fn(params, x[0])


# ---------------------------------------------------------------------------
# FlowEngine(mesh=)
# ---------------------------------------------------------------------------
ENGINE_CFG = dict(encoder="cnn", decoder_depth=2, corr_levels=2, corr_radius=2, feature_dim=64)


@pytest.fixture(scope="module")
def engines():
    """The one-device port engine and one over 3 CPU replicas, on the same
    seeded weights, f32 volumes; a clip of 10 frames of 40x48 (10 windows
    over 3 replicas, as the JAX test's 10 over 8) and one of 5 frames of
    40x150 (four 40x40 tiles at tile_size 40)."""
    cfg = ModelConfig(sequence_length=3, **ENGINE_CFG)
    one = FlowEngine(cfg, device="cpu", seed=3)
    one.model.corr_dtype = torch.float32
    one.load_model(allow_random_init=True)
    mesh = FlowEngine(cfg, device="cpu", mesh=cpu_mesh(3), params=one.model.state_dict())
    mesh.model.corr_dtype = torch.float32
    assert mesh.load_model() == "preloaded"
    rng = np.random.default_rng(5)
    small = rng.integers(0, 256, (10, 40, 48, 3), dtype=np.uint8)
    wide = rng.integers(0, 256, (5, 40, 150, 3), dtype=np.uint8)
    return one, mesh, small, wide


def close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_mesh_compute_flow_batch(engines, monkeypatch):
    """10 windows padded to 12, 4 per replica; the padded windows are cut."""
    one, mesh, small, _ = engines
    sizes = []
    for _, model in mesh._slots():
        refine = model.refine
        monkeypatch.setattr(model, "refine", lambda enc, refine=refine: sizes.append(enc.batch) or refine(enc))
    got = mesh.compute_flow_batch(small, list(range(10)))
    assert got.shape == (10, 40, 48, 2) and sizes == [4, 4, 4]
    close(got, one.compute_flow_batch(small, list(range(10))))
    # Replicas 0 and 1 ran batches a one-device call of 4 windows runs.
    fours = np.concatenate([one.compute_flow_batch(small, [0, 1, 2, 3]), one.compute_flow_batch(small, [4, 5, 6, 7])])
    np.testing.assert_array_equal(got[:8], fours)
    # One window padded to three: replica 0 runs it alone, as one device does.
    np.testing.assert_array_equal(mesh.compute_flow(small, 9), one.compute_flow(small, 9))


def test_mesh_compute_flows_strided(engines):
    """window_batch 1 rounds up to 3, one window per replica: bit for bit the
    one-device window_batch=1 run (T=3, stride 1: ten windows, the last
    batch padded from one window to three)."""
    one, mesh, small, _ = engines
    got = mesh.compute_flows_strided(small, window_batch=1)
    np.testing.assert_array_equal(got, one.compute_flows_strided(small, window_batch=1))
    close(mesh.compute_flows_strided(small, window_batch=4), got)


@pytest.mark.parametrize("tile_batch", [1, 4])
def test_mesh_compute_flow_tiled(engines, tile_batch):
    """Four tiles of one shape group; tile_batch 1 rounds up to 3 (one tile
    per replica: bit for bit the one-device tile_batch=1; the second chunk,
    one tile, padded to three), 4 to 6 (the four tiles padded to six)."""
    one, mesh, _, wide = engines
    assert [len(i) for i in one._tiling(40, 150, 40)[1].values()] == [4]
    got = mesh.compute_flow_tiled(wide, 2, tile_size=40, tile_batch=tile_batch)
    ref = one.compute_flow_tiled(wide, 2, tile_size=40, tile_batch=1)
    if tile_batch == 1:
        np.testing.assert_array_equal(got, ref)
    else:
        close(got, ref)


@pytest.mark.parametrize("window_batch", [1, 2, 4])
def test_mesh_compute_flows_tiled_stride1(engines, window_batch):
    """window_batch 1 and 2 become 3 (one window per replica: bit for bit the
    one-device window_batch=1), 4 becomes 6; 5 frames make a padded last
    batch.  Every frame reaches progress_cb once, in order."""
    one, mesh, _, wide = engines
    seen = []
    got = mesh.compute_flows_tiled_stride1(wide, tile_size=40, window_batch=window_batch,
                                           progress_cb=lambda i, f: seen.append(i))
    assert seen == list(range(5))
    ref = one.compute_flows_tiled_stride1(wide, tile_size=40)
    if window_batch < 3:
        np.testing.assert_array_equal(got, ref)
    else:
        close(got, ref)


def test_mesh_window_batch_clamp_is_per_card(engines, monkeypatch):
    """The stride-1 clamp under TPUFLOW_WB_HBM_BUDGET (bytes per card): the
    three replicas share the one device's budget, each keeps at least one
    window, and the batch stays a multiple of the axis."""
    from tpuflow_torch.core.corr import dense_volume_bytes

    one, mesh, _, _ = engines
    _, groups = mesh._tiling(40, 150, 40)
    # T = 3: one interior, two directions, four tiles of a 5x5 grid.
    per_win = 2 * 4 * dense_volume_bytes(5, 5, 2, torch.float32)
    monkeypatch.setenv("TPUFLOW_WB_HBM_BUDGET", str(2 * per_win))
    assert one._clamp_window_batch(8, 3, groups) == 2
    assert mesh._clamp_window_batch(9, 3, groups) == 3      # 2/3 of a window per replica: 1 each
    monkeypatch.setenv("TPUFLOW_WB_HBM_BUDGET", str(6 * per_win))
    assert mesh._clamp_window_batch(9, 3, groups) == 6
    assert mesh._clamp_window_batch(3, 3, groups) == 3
    assert mesh.get_memory_usage() == {"message": "Memory tracking not available on this backend"}


# ---------------------------------------------------------------------------
# the 'xla' lookup, the loss and the train step against the JAX package
# ---------------------------------------------------------------------------
def test_xla_lookup_matches_jax_and_patch():
    """DenseCorrPyramid.lookup(impl='xla') equals impl='patch' bit for bit,
    matches the JAX package's XLA lookup, and so do its gradients in the
    volumes and the flow (the JAX lookup differentiated by jax.grad)."""
    rng = np.random.default_rng(2)
    b, h, w, c, r = 2, 6, 7, 16, 2
    f1 = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.float32)
    f2 = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.float32)
    jpyr = JaxDense.build(f1, f2, 3)
    flow = (rng.random((b, h, w, 2)) * 2 - 1).astype(np.float32) * np.array([1.2 * w, 1.2 * h], np.float32)
    weight = rng.standard_normal((b, h, w, 3 * (2 * r + 1) ** 2)).astype(np.float32)

    def jloss(levels, fl):
        return jnp.sum(JaxDense(levels, (b, h, w), (h, w)).lookup(fl, r, impl="xla") * weight)

    ref = np.asarray(jpyr.lookup(jnp.asarray(flow), r, impl="xla"))
    gvol, gflow = jax.grad(jloss, argnums=(0, 1))(list(jpyr.pyramid), jnp.asarray(flow))

    vols = [torch.from_numpy(v).requires_grad_() for v in _flat_levels(jpyr)]
    tflow = torch.from_numpy(flow).requires_grad_()
    pyr = DenseCorrPyramid(vols)
    got = pyr.lookup(tflow, r, impl="xla")
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_array_equal(pyr.lookup(tflow, r, impl="patch").numpy(), got.detach().numpy())
    (got * torch.from_numpy(weight)).sum().backward()
    for v, g in zip(vols, _flat_levels(JaxDense(list(gvol), (b, h, w), (h, w)))):
        np.testing.assert_allclose(v.grad.numpy(), g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tflow.grad.numpy(), np.asarray(gflow), rtol=1e-4, atol=1e-4)


def test_epe_loss_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.normal(0, 3, (2, 9, 11, 2)).astype(np.float32)
    target = rng.normal(0, 3, (2, 9, 11, 2)).astype(np.float32)
    pred[0, 0, 0] = target[0, 0, 0]                       # a zero error: the 1e-8 floor
    ref = float(jsharding.epe_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = epe_loss(torch.from_numpy(pred), torch.from_numpy(target)).item()
    assert got == pytest.approx(ref, rel=1e-6)


def train_batch(b: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    windows = rng.random((b, 3, TRAIN_HW, TRAIN_HW, 3), dtype=np.float32)
    targets = rng.normal(0, 1, (b, TRAIN_HW, TRAIN_HW, 2)).astype(np.float32)
    return windows, targets


@pytest.fixture(scope="module")
def jax_training():
    """The JAX MOFNet on its plain paths (dense_lookup='xla',
    gma_impl='xla', the refinement unrolled for reverse-mode AD), a random
    flax tree, and on a batch of 2 windows: the loss and gradients of one
    step (jitted value_and_grad) and the parameters after each of 2 steps,
    and their losses, of the jitted, unsharded make_train_step under
    optax.adamw(1e-4) with init_hidden_state held out (HELD); and the jitted
    loss, for a tree of the port's parameters.

    init_hidden_state is zero in the tree.  Both sides start the refinement
    from it (tests/jax_learned_start.py on the JAX side), so its gradient is
    compared with the others.  Both sides hold it out of the optimizer (see
    test_train_step_matches_jax), so the two steps are the ones the test
    held before the refinement read it.  The learned start's forward, at a
    nonzero state, is held to the mirror by
    tests/test_torch_port_mof_start.py."""
    import optax

    jm = JaxMOFNet(dtype=jnp.float32, corr_dtype=jnp.float32, dense_lookup="xla", gma_impl="xla",
                   scan_iters=False, **TRAIN)
    flat = random_flax_params(jm, seed=3, h=TRAIN_HW, w=TRAIN_HW)
    key = next(k for k in flat if k.endswith(HELD))
    flat[key] = np.zeros_like(flat[key])
    params = unflatten_params(flat)
    windows, targets = train_batch(2)

    def loss_fn(p):
        fwd, _ = jm.apply(p, windows)
        return jsharding.epe_loss(fwd[:, fwd.shape[1] // 2], targets)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss_at = jax.jit(loss_fn)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "held" if HELD in jax.tree_util.keystr(path) else "adamw", params)
    opt = optax.multi_transform({"adamw": optax.adamw(LR), "held": optax.set_to_zero()}, labels)
    step = jax.jit(jsharding.make_train_step(jm, opt))
    state = opt.init(params)
    p1, state, l1 = step(params, state, windows, targets)
    p2, state, l2 = step(p1, state, windows, targets)
    return {
        "flat": flat, "windows": windows, "targets": targets, "loss": float(loss),
        "grads": state_dict_from_jax(flatten_params(grads)), "losses": [float(l1), float(l2)],
        "params1": state_dict_from_jax(flatten_params(p1)),
        "params": state_dict_from_jax(flatten_params(p2)),
        "loss_at": lambda sd: float(loss_at(flax_tree_from_state_dict(sd))),
    }


def port_model(flat) -> MOFNet:
    model = MOFNet(corr_dtype=torch.float32, dense_lookup="xla", gma_impl="xla", **TRAIN)
    model.load_state_dict(state_dict_from_jax(flat), strict=True)
    return model


def adamw(model, held: str | None = None):
    params = [p for k, p in model.named_parameters() if held is None or not k.endswith(held)]
    return torch.optim.AdamW(params, lr=LR, weight_decay=1e-4, eps=1e-8)


def grad_close(got: torch.Tensor, ref: torch.Tensor, share: float, floor: float, what: str):
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= share * scale + floor, f"{what}: {err} of {scale}"


def test_train_step_matches_jax(jax_training):
    """The port's make_train_step (AdamW(lr=1e-4, weight_decay=1e-4,
    eps=1e-8), optax.adamw(1e-4)'s counterpart) on the JAX tree's weights:
    the first loss and every gradient, the parameters after the first step,
    then the losses of 2 steps and the parameters after them.

    Both sides hold init_hidden_state (zero) out of the optimizer.  The
    second loss is steep in the parameters (the first step takes it from
    6.37 to 2.52), and torch and optax round AdamW's update in other orders,
    so about half the entries after the first step part by one f32 ulp; the
    two trajectories' second losses part by 9.95e-6 of the loss for that
    alone, and by 1.02e-5 once init_hidden_state moves by lr as well.  Held
    out, the two steps are those the test held before the refinement read
    the state, and its gradient is still compared.  The second step's loss
    is also compared with the JAX model's at the port's own parameters
    after the first step (2e-7 apart)."""
    ref = jax_training
    model = port_model(ref["flat"])
    step = make_train_step(model, adamw(model, held=HELD))
    w, t = torch.from_numpy(ref["windows"]), torch.from_numpy(ref["targets"])
    losses = [step(w, t).item()]
    assert losses[0] == pytest.approx(ref["loss"], rel=1e-5)
    first = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert set(first) == set(ref["grads"])
    for k, g in first.items():
        grad_close(g, ref["grads"][k], 1e-3, 1e-6, k)
    for k, p in model.state_dict().items():               # one step: lr per entry, to f32 rounding
        moved = ref["grads"][k].abs() > 1e-6
        assert ((p - ref["params1"][k]).abs() * moved).max().item() <= 1e-2 * LR, k
    jax_second = ref["loss_at"](model.state_dict())
    losses.append(step(w, t).item())
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    assert losses[1] == pytest.approx(jax_second, rel=1e-5)
    init = state_dict_from_jax(ref["flat"])
    for k, p in model.state_dict().items():
        for side in (p, ref["params"][k]):                # within two steps' reach
            assert (side - init[k]).abs().max().item() <= 2 * LR * (1 + 1e-3) + 1e-7, k
        if ref["grads"][k].abs().max() > 1e-6:
            ours, theirs = p - init[k], ref["params"][k] - init[k]
            assert (ours - theirs).norm() <= 0.05 * theirs.norm(), k
        if k.endswith(HELD):
            assert torch.equal(p, init[k]) and torch.equal(ref["params"][k], init[k]), k


@pytest.mark.parametrize("batch", [2, 3], ids=["even", "ragged"])
def test_shard_train_step_matches_whole_batch(batch):
    """shard_train_step over 2 replicas (1 + 1 and 2 + 1 windows) against one
    step on the whole batch: the loss, the gradients averaged by shard size,
    and the parameters after an SGD step; the replica is refreshed."""
    torch.manual_seed(0)
    base = MOFNet(corr_dtype=torch.float32, dense_lookup="xla", gma_impl="xla", **TRAIN)
    from tpuflow_torch.runtime.engine import init_random_

    init_random_(base, 7)
    whole, split = copy.deepcopy(base), copy.deepcopy(base)
    w, t = (torch.from_numpy(x) for x in train_batch(batch, seed=batch))
    ref_loss = make_train_step(whole, torch.optim.SGD(whole.parameters(), lr=1e-2))(w, t).item()
    step = shard_train_step(make_train_step(split, torch.optim.SGD(split.parameters(), lr=1e-2)), cpu_mesh(2))
    loss = step(w, t).item()
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for (k, a), b in zip(whole.named_parameters(), split.parameters()):
        grad_close(b.grad, a.grad, 1e-5, 1e-7, k)
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
    for a, b in zip(split.parameters(), step.replicas[1].parameters()):
        assert torch.equal(a, b)


def test_shard_train_step_needs_the_model_on_the_first_slot():
    model = MOFNet(dense_lookup="xla", gma_impl="xla", **TRAIN)
    with pytest.raises(ValueError, match="first slot"):
        shard_train_step(make_train_step(model, adamw(model)), Mesh([torch.device("cuda", 0)] * 2))


# ---------------------------------------------------------------------------
# kernels that refuse a gradient
# ---------------------------------------------------------------------------
def wrapper_calls():
    """(name, call) for every kernel entry on small CPU inputs that require
    a gradient."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    vols = [rand(2 * 3 * 4, 3, 4), rand(2 * 3 * 4, 1, 2)]
    flow = torch.zeros(2, 3, 4, 2)
    idx = torch.zeros(2, 12, 2, dtype=torch.int32)
    band = rand(2, 3, 12, 4)
    q = rand(2, 10, 128)
    f1, f2l = rand(1, 12, 16), rand(1, 3, 4, 16)
    return {
        "dense_lookup": lambda: dense_lookup(vols, flow, 1),
        "dense_patch_levels": lambda: dense_patch_levels(vols, [idx, idx], [idx, idx])[1],
        "dense_patch_level": lambda: dense_patch_level(vols[0], idx, idx),
        "band_patch_levels": lambda: band_patch_levels([band], [idx], [idx])[0],
        "band_patch_level": lambda: band_patch_level(band, idx, idx),
        "flash_attention_fwd": lambda: flash_attention_fwd(q, q, q),
        "flash2_patch_level": lambda: flash2_patch_level(f1[:1], f2l, idx[:1], idx[:1], grid_w=4),
        "flash_patch_level": lambda: flash_patch_level(f1[:1], f2l, idx[:1], idx[:1]),
        "depthwise_residual_gelu": lambda: depthwise_residual_gelu(rand(1, 6, 7, 4), rand(4, 1, 7, 7), rand(4)),
        "memory_read": lambda: memory_read(rand(1, 6, 64), rand(1, 2, 6, 64), rand(1, 2, 6, 128), torch.ones(1, 2)),
    }


@pytest.mark.parametrize("name", list(wrapper_calls()))
def test_kernel_wrappers_refuse_a_gradient(name):
    """Every kernel entry runs its forward with grad enabled (the plain
    version here) and counts no launch on the CPU; a backward through its
    result raises and names the differentiable formulations."""
    counters = [f"kernels.{fn.__name__}.launches" for fn in (dense_lookup, dense_patch_level, band_patch_level,
                                                             flash_attention_fwd, flash2_patch_level, flash_patch_level,
                                                             depthwise_residual_gelu, memory_read)]

    def launches():
        found = profiling.snapshot()["counters"]
        return [found.get(c, 0) for c in counters]

    before = launches()
    out = wrapper_calls()[name]()
    assert out.requires_grad and torch.isfinite(out).all()
    assert launches() == before
    with pytest.raises(RuntimeError, match=r"dense_lookup='xla' and gma_impl='xla'"):
        out.float().sum().backward()
    with torch.no_grad():
        assert not wrapper_calls()[name]().requires_grad


@pytest.mark.parametrize("name", list(wrapper_calls()))
def test_kernel_wrappers_skip_the_function_without_a_graph(monkeypatch, name):
    """With grad off, where autograd records nothing, an entry runs without
    the refusing Function (whose host cost inference does not pay)."""
    from tpuflow_torch.kernels import _nograd

    def refuse_apply(*args):
        raise AssertionError("the refusing Function ran under no_grad")

    monkeypatch.setattr(_nograd._Refuse, "apply", refuse_apply)
    with torch.no_grad():
        out = wrapper_calls()[name]()
    assert not out.requires_grad and torch.isfinite(out).all()


@pytest.mark.parametrize("dense_lookup_impl,gma_impl,refuses", [
    ("auto", "xla", "dense_lookup"), ("patch", "xla", "dense_patch_levels"),
    ("xla", "auto", "flash_attention_fwd"), ("xla", "flash", "flash_attention_fwd"), ("xla", "xla", None),
])
def test_model_backward_through_kernels_raises(dense_lookup_impl, gma_impl, refuses):
    """A MOFNet backward reaches K1, K4 or K2 and raises naming it, or, on
    the plain formulations, gives every parameter a gradient (the
    refinement starts from init_hidden_state, so it has one too)."""
    model = MOFNet(corr_dtype=torch.float32, dense_lookup=dense_lookup_impl, gma_impl=gma_impl, **TRAIN)
    from tpuflow_torch.runtime.engine import init_random_

    init_random_(model, 1)
    w, t = (torch.from_numpy(x) for x in train_batch(1))
    fwd, _ = model(w)
    loss = epe_loss(fwd[:, 0], t)
    if refuses:
        with pytest.raises(RuntimeError, match=f"^{refuses} has no backward"):
            loss.backward()
        return
    loss.backward()
    missing = [k for k, p in model.named_parameters() if p.grad is None]
    assert missing == []
    with pytest.raises(ValueError, match="gma_impl"):
        model.gma_impl = "pallas"
