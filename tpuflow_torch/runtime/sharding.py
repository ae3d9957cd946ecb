"""Data parallelism over devices, and the train step (port of
tpuflow/runtime/sharding.py on torch).

- `Mesh`: devices in a grid with named axes, as `jax.sharding.Mesh`, of
  `torch.device`s.  One device may appear more than once: each slot of the
  'data' axis gets a replica of its own (a host with one card can still
  run the split, and the tests list the CPU).
- `make_mesh`: 1-D or 2-D meshes over the visible cards.
- `shard_batch_forward`: split dim 0 of a batch over 'data', run a replica
  of the parameters on each slot's device, concatenate on the first device.
  The JAX package jits the same function with the batch sharded; here each
  replica runs its shard eagerly, and the replicas' work queues on their
  devices one after the other.
- `epe_loss`, `make_train_step` and `shard_train_step`: the supervised EPE
  step, and its data-parallel form (gradients averaged by shard size, also
  over the processes of an initialized torch.distributed world).
- `spatial_sharding` and `shard_spatial_forward`: one frame's height split
  over the mesh's 'spatial' slots (and the batch over 'data'), with the
  halo exchanges and gathers of core/strips.py.  The JAX package jits an
  arbitrary function and lets GSPMD partition it; torch cannot partition an
  arbitrary function, so the port's version takes the model (MOFNet or
  BOFNet) and runs the model's own forward on every strip, one host thread
  per mesh slot.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..core import strips
from ..core.mofnet import MOFNet


class Mesh:
    """`devices` (nested sequences, one level per axis) of torch.device, with
    `axis_names` and `shape` ({axis: size}) as jax.sharding.Mesh."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("data",)):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(dev)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    def data_devices(self) -> List[torch.device]:
        """One device per slot of the 'data' axis (the first slot of every
        other axis), in order; the whole grid when there is no 'data' axis
        is one slot."""
        if "data" not in self.axis_names:
            return [self.devices.flat[0]]
        axis = self.axis_names.index("data")
        return list(np.moveaxis(self.devices, axis, 0).reshape(self.devices.shape[axis], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None, axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh of the first `n_devices` visible cards (default all of them,
    cuda:0 .. cuda:{torch.cuda.device_count() - 1}).  A 2-D mesh puts the
    larger factor of n on 'data', as the JAX package's does.  A mesh that
    lists a device more than once, or the CPU, is a `Mesh` built directly."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_devices or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from {len(devices)} available")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    if len(axis_names) == 1:
        return Mesh(grid, axis_names)
    d = int(np.floor(np.sqrt(n)))
    while n % d:
        d -= 1
    return Mesh(grid.reshape(n // d, d), axis_names)


def shard_sizes(n: int, slots: int) -> List[int]:
    """Rows of each of `slots` shards of a batch of n: sizes differ by at most
    one, the leading shards the larger."""
    base, rem = divmod(n, slots)
    return [base + (1 if i < rem else 0) for i in range(slots)]


def split_batch(x, slots: int) -> list:
    """Dim 0 of x (a tensor or a numpy array) in `slots` contiguous shards
    (shard_sizes; empty shards kept)."""
    sizes = shard_sizes(len(x), slots)
    if isinstance(x, torch.Tensor):
        return list(torch.split(x, sizes))
    return np.split(x, np.cumsum(sizes)[:-1])


def replicate_params(params: Dict[str, torch.Tensor], devices: Sequence[torch.device]) -> List[Dict]:
    """One copy of `params` per device slot.  A slot on the parameters' own
    device shares them; every other slot gets its own copy."""
    out = []
    for dev in devices:
        out.append({k: (v if v.device == dev and not out else v.detach().to(dev, copy=True))
                    for k, v in params.items()})
    return out


def shard_batch_forward(fn: Callable, mesh: Mesh, batch_ndim: int) -> Callable:
    """`fn(params, batch)` with dim 0 of batch split over 'data' and the
    params replicated: returns `sharded(params, batch)`, which runs fn on
    each slot's device with that slot's replica of params (copied on every
    call, as the JAX package's jit places its replicated argument), and
    concatenates the outputs on the first device.  fn must be independent
    per batch row, as the JAX package's is for its sharding to hold; for a
    module, fn may be `lambda p, x: torch.func.functional_call(model, p, (x,))`."""
    devices = mesh.data_devices()

    def sharded(params: Dict[str, torch.Tensor], batch: torch.Tensor) -> torch.Tensor:
        if batch.dim() != batch_ndim:
            raise ValueError(f"batch of {batch.dim()} dims, expected {batch_ndim}")
        shards = split_batch(batch, len(devices))
        outs = [fn(p, shard.to(dev)) for p, dev, shard in zip(replicate_params(params, devices), devices, shards)
                if shard.shape[0]]
        return torch.cat([o.to(devices[0]) for o in outs])

    return sharded


# ---------------------------------------------------------------------------
# Spatial sharding
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SpatialSharding:
    """The port's counterpart of the JAX package's NamedSharding for frames
    split by height: `spec[i]` names the mesh axis that splits dim i ('data'
    for dim 0, 'spatial' for the height), None where the dim stays whole."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    @property
    def h_axis(self) -> int:
        return self.spec.index("spatial")

    def slots(self) -> np.ndarray:
        """The devices of the mesh as a ('data', 'spatial') grid: an axis the
        mesh lacks has one slot, and of any other axis the first slot is
        taken (as Mesh.data_devices)."""
        grid = self.mesh.devices
        names = list(self.mesh.axis_names)
        for axis in ("data", "spatial"):
            if axis not in names:
                grid, names = grid[..., None], names + [axis]
        grid = np.moveaxis(grid, [names.index("data"), names.index("spatial")], [0, 1])
        return grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]


def spatial_sharding(mesh: Mesh, ndim: int, h_axis: int) -> SpatialSharding:
    """Shard a spatial (height) dim over 'spatial', dim 0 over 'data'."""
    spec = [None] * ndim
    spec[0] = "data"
    spec[h_axis] = "spatial"
    return SpatialSharding(mesh, tuple(spec))


class SpatialForward:
    """`sharded(params, frames)`: see shard_spatial_forward.  The model's
    options (corr_impl, dense_lookup, gma_impl, materialize_threshold) are
    read when this is made.  `groups` holds the strip groups of the last call
    (their `fetched_bytes` count what the strips took from each other)."""

    def __init__(self, model: nn.Module, sharding: SpatialSharding, batch_ndim: int):
        self.sharding = sharding
        self.batch_ndim = batch_ndim
        self.devices = sharding.slots()
        # One copy of the module per slot, on no device: each slot's thread
        # calls its own copy with its replica of the parameters.
        self.replicas = [copy.deepcopy(model).to("meta") for _ in range(self.devices.size)]
        self.groups: List[strips.StripGroup] = []

    def __call__(self, params: Dict[str, torch.Tensor], frames: torch.Tensor):
        h_axis = self.sharding.h_axis
        if frames.dim() != self.batch_ndim:
            raise ValueError(f"frames of {frames.dim()} dims, expected {self.batch_ndim}")
        n_data, n_spatial = self.devices.shape
        h = frames.shape[h_axis]
        if h % 8 or h // 8 < n_spatial:
            raise ValueError(f"height {h} must be a multiple of 8 with a feature row for each of "
                             f"{n_spatial} 'spatial' slots")
        rows = shard_sizes(h // 8, n_spatial)
        flat = list(self.devices.flat)
        replicas = replicate_params(params, flat)
        shards = split_batch(frames, n_data)
        self.groups = [strips.StripGroup(rows) for _ in range(n_data)]
        outs: Dict[Tuple[int, int], object] = {}
        errors: List[BaseException] = []
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

        def run(d: int, s: int) -> None:
            slot = d * n_spatial + s
            dev = self.devices[d, s]
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                        (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                    x = shards[d].narrow(h_axis, 8 * sum(rows[:s]), 8 * rows[s]).to(dev)
                    token = strips.enter(strips.Strip(self.groups[d], s)) if n_spatial > 1 else None
                    try:
                        outs[d, s] = torch.func.functional_call(self.replicas[slot], replicas[slot], (x,))
                    finally:
                        if token is not None:
                            strips.leave(token)
            except BaseException as exc:  # noqa: BLE001 - handed to the caller below
                errors.append(exc)
                for group in self.groups:
                    group.abort()

        threads = [threading.Thread(target=run, args=(d, s), name=f"strip-{d}-{s}", daemon=True)
                   for d in range(n_data) if shards[d].shape[0] for s in range(n_spatial)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # The strip that failed first, not the strips its abort stopped.
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
        first = self.devices[0, 0]

        def assemble(parts_of):
            return torch.cat([torch.cat([parts_of(d, s).to(first) for s in range(n_spatial)], dim=2)
                              for d in range(n_data) if shards[d].shape[0]])

        sample = outs[0, 0]
        if isinstance(sample, tuple):
            return tuple(assemble(lambda d, s, i=i: outs[d, s][i]) for i in range(len(sample)))
        return assemble(lambda d, s: outs[d, s])


def shard_spatial_forward(model: nn.Module, mesh: Mesh, batch_ndim: int, h_axis: int) -> SpatialForward:
    """`sharded(params, frames)`: `model` (a MOFNet or BOFNet, Twins or cnn
    encoder) on frames [B, T, H, W, 3] (H and W multiples of 8) with the
    height split over the mesh's 'spatial' slots and dim 0 over 'data'
    (`spatial_sharding`); `params` is its state dict, replicated to every
    slot as `replicate_params` does.  Returns what `model(frames)` returns,
    on the mesh's first device.

    Each slot's strip is whole feature rows (8 pixel rows), as even as
    `shard_sizes` makes them (135 rows over four slots: 34, 34, 34, 33),
    and one host thread per slot runs the model's own forward on it with
    the strip current (core/strips.py): convolutions fetch their halos,
    norms sum their statistics, the windowed attention fetches its windows'
    rows, the global attention, the correlation and GMA read every strip's
    rows.  The
    value is the unsharded forward's up to float reassociation; with one
    'spatial' slot no strip is made and each 'data' slot runs the forward as
    it is.  One strip's exception makes the call raise it, after every
    thread has ended.  The JAX package's version jits any `fn(params,
    frames)` under GSPMD; MemFlow is not reached there (its only callers run
    MOFNet) and is refused here."""
    if not isinstance(model, MOFNet):
        raise TypeError(f"shard_spatial_forward runs a MOFNet or BOFNet, not {type(model).__name__}")
    if (batch_ndim, h_axis) != (5, 2):
        raise ValueError(f"MOFNet takes frames [B, T, H, W, 3]: batch_ndim 5 and h_axis 2, "
                         f"got {batch_ndim} and {h_axis}")
    return SpatialForward(model, spatial_sharding(mesh, batch_ndim, h_axis), batch_ndim)


# ---------------------------------------------------------------------------
# Training (supervised EPE)
# ---------------------------------------------------------------------------
def epe_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean end-point error."""
    return torch.mean(torch.sqrt(torch.sum((pred - target) ** 2, dim=-1) + 1e-8))


def window_loss(model: nn.Module, windows: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """EPE of the middle interior frame's forward flow: windows [B, T, H, W,
    3] in [0, 1], targets [B, H, W, 2] (tpuflow/runtime/sharding.py:105)."""
    fwd_flows, _ = model(windows)
    return epe_loss(fwd_flows[:, fwd_flows.shape[1] // 2], targets)


class TrainStep:
    """One optimizer step on a batch: `step(windows, targets) -> loss` (a
    detached scalar tensor).  The model and the optimizer hold the state that
    the JAX step threads through its arguments (params, opt_state)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer

    def __call__(self, windows: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = window_loss(self.model, windows, targets)
        loss.backward()
        _zero_missing(self.model.parameters())
        self.optimizer.step()
        return loss.detach()


def _zero_missing(params) -> None:
    """A parameter the loss does not reach gets a zero gradient, as jax.grad
    gives it, so that the optimizer still decays it."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainStep:
    """The train step of `model` (MOFNet or BOFNet built with
    dense_lookup='xla' and gma_impl='xla': the kernels refuse a gradient)
    under `optimizer` (a torch.optim optimizer over model.parameters()).
    The counterpart of the JAX package's optax.adamw(1e-4) is
    torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4, eps=1e-8): torch's
    default weight decay is 1e-2, optax's 1e-4, and both decay decoupled."""
    return TrainStep(model, optimizer)


class ShardedTrainStep:
    """`step(windows, targets) -> loss`: the batch split over the mesh's
    'data' slots, one model replica per slot (the first is the step's model,
    on the first slot's device), gradients averaged by shard size into the
    model's parameters (so that the step equals one on the whole batch), and
    averaged over the processes of an initialized torch.distributed world of
    more than one, then one optimizer step and the replicas refreshed."""

    def __init__(self, step: TrainStep, mesh: Mesh):
        self.step = step
        self.devices = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None
                        else d for d in mesh.data_devices()]
        first = next(step.model.parameters()).device
        if first != self.devices[0]:
            raise ValueError(f"the model is on {first}, the mesh's first slot on {self.devices[0]}")
        self.replicas = [step.model] + [copy.deepcopy(step.model).to(dev) for dev in self.devices[1:]]

    def __call__(self, windows: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model, optimizer = self.step.model, self.step.optimizer
        n = windows.shape[0]
        params = [list(r.parameters()) for r in self.replicas]
        total = torch.zeros((), device=self.devices[0])
        grads: List[Optional[torch.Tensor]] = [None] * len(params[0])
        for replica, ps, dev, w, t in zip(self.replicas, params, self.devices,
                                          split_batch(windows, len(self.devices)),
                                          split_batch(targets, len(self.devices))):
            if w.shape[0] == 0:
                continue
            for p in ps:
                p.grad = None
            loss = window_loss(replica, w.to(dev), t.to(dev))
            loss.backward()
            share = w.shape[0] / n
            total = total + share * loss.detach().to(self.devices[0])
            for i, p in enumerate(ps):
                if p.grad is not None:
                    g = share * p.grad.to(self.devices[0])
                    grads[i] = g if grads[i] is None else grads[i] + g
        if dist.is_initialized() and dist.get_world_size() > 1:
            total, grads = _world_mean(total, grads, params[0])
        for p, g in zip(params[0], grads):
            p.grad = g
        _zero_missing(params[0])
        optimizer.step()
        with torch.no_grad():
            for ps in params[1:]:
                for p, p0 in zip(ps, params[0]):
                    p.copy_(p0)
        return total


def _world_mean(loss: torch.Tensor, grads: List[Optional[torch.Tensor]], params: List[torch.Tensor]):
    """The loss and the gradients averaged over the world, in one all-reduce
    of a flat buffer (on the CPU for gloo).  A gradient that a process does
    not have counts as zeros there."""
    full = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in full])
    if dist.get_backend() == "gloo":
        flat = flat.cpu()
    dist.all_reduce(flat)
    flat = (flat / dist.get_world_size()).to(loss.device)
    out, i = [], 1
    for p in params:
        out.append(flat[i : i + p.numel()].view_as(p))
        i += p.numel()
    return flat[0], out


def shard_train_step(train_step: TrainStep, mesh: Mesh) -> ShardedTrainStep:
    """The train step over the mesh: parameters and optimizer state
    replicated, the batch split over 'data' (see ShardedTrainStep)."""
    return ShardedTrainStep(train_step, mesh)
