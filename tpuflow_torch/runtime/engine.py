"""FlowEngine: the port's inference engine (tpuflow/runtime/engine.py), for
VideoFlow (MOF and BOF) and MemFlow.

- `compute_flows_tiled_stride1`: flows for every frame of a clip, one
  centred window per output frame (reference stride-1 semantics,
  videoflow_core.py:193-195), tiles batched per shape group, each frame's
  per-tile encoder features computed once and kept in a rolling cache.
  `window_batch` windows stack window-major along the tile batch (clamped
  so that their correlation volumes fit the card, `_clamp_window_batch`),
  and dispatch is pipelined one batch deep: a batch's flows are copied to
  pinned host memory behind its refinement and pasted while the next batch
  runs.
- `compute_flow_tiled`: one frame's flow in tile mode, `tile_batch` tiles
  of a shape group at a time.
- `compute_flow` / `compute_flow_batch`: untiled full-frame flows, one
  centred window per requested frame, windows on the batch axis.
- `compute_flows_strided`: untiled flows for every frame from windows that
  advance by T-2 frames, every interior flow kept.

All pad frames (or tiles) to a multiple of 8 with edge replication and run
the model; the stride-1 and per-frame entry points keep the middle interior
frame's forward flow, and tile mode pastes the tiles back (reference hard
paste).  A frame that fits one tile goes to `compute_flow`, as in the JAX
engine.  Numpy in, numpy out.  Runs on the card unless the caller passes
device='cpu'.

MemFlow (`ModelConfig(model='memflow')`): `stream_flows` carries the
model's memory across a clip, frame i's flow from the pair (i-1, i);
`compute_flow` / `compute_flow_batch` run each requested frame's last two
frames on an empty memory, as the reference's per-call inference does; the
tile entry points run whole frames through `compute_flow` (MemFlow never
tiles).

`mesh` (runtime/sharding.py): each slot of its 'data' axis gets a replica of
the model on the slot's device (the first slot's is `model` itself), and
every batched dispatch of the VideoFlow entries is split over the replicas,
padded to a multiple of the axis by repeating its last window or tile, as
the JAX engine pads its sharded batches; the padded rows are cut before any
flow is pasted or returned.  The kernels run per replica on its shard, the
counterpart of the JAX package's shard_map around its kernels.  MemFlow's
entries run on the first slot.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import TILE_SIZE, ModelConfig
from ..core.corr import dense_volume_bytes
from ..core.memflownet import CARRY_CLAMP, MemFlowNet
from ..core.mofnet import BOFNet, MOFNet
from ..core.padding import pad_dims, pad_frames_edge
from .convert import VIDEOFLOW_IGNORE, load_torch_state_dict
from .checkpoint import is_native_checkpoint, load_params
from .convert_memflow import MEMFLOW_IGNORE
from .device import resolve_device
from .profiling import count, span
from .sharding import Mesh, split_batch
from .tiles import (
    calculate_tile_grid,
    extract_tile_group,
    group_tiles_by_shape,
    paste_tile_flows,
    resolve_tile_layout,
)
from .windows import centered_window_indices, trailing_window_indices

# Sentinel checkpoint paths: explicit opt-in to seeded random weights (the
# second is the one bench.py and the JAX package's benchmarks pass).
RANDOM_INIT = "__random_init__"
BENCH_RANDOM_INIT = "__bench_random_init__"

# Window batching on the card: the correlation volumes of one batch may take
# the card's free memory less this share of it, which is left to the
# refinement's activations (see _clamp_window_batch).  The JAX package's
# override, read under the same name, sets the volumes' budget in bytes.
WB_BUDGET_ENV = "TPUFLOW_WB_HBM_BUDGET"
WB_ACTIVATION_SHARE = 0.25
# The host's paste of a frame's tile flows into the whole frame.
PASTE_SPAN = span("tpuflow.engine.paste")


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (as engine.py:57-63)."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def build_model(
    cfg: ModelConfig,
    encoder: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    dense_lookup: str = "auto",
) -> nn.Module:
    """MemFlowNet for model 'memflow', else MOFNet, or BOFNet for architecture
    'bof', for `cfg` on `device` in `dtype` (default: bf16 on the card, f32
    on the CPU), parameters uninitialized until loaded.  `encoder=None`
    follows cfg.encoder ('twins' or 'cnn').  `dense_lookup`: how a
    DenseCorrPyramid is looked up ('auto' = the fused kernel K1, 'patch',
    'xla'; see MOFNet)."""
    dev = resolve_device(device)
    kw = dict(
        corr_levels=cfg.corr_levels,
        corr_radius=cfg.corr_radius,
        decoder_depth=cfg.decoder_depth,
        feature_dim=cfg.feature_dim,
        hidden_dim=cfg.hidden_dim,
        context_dim=cfg.context_dim,
        encoder=encoder or cfg.encoder,
        corr_impl=cfg.corr_impl,
        dense_lookup=dense_lookup,
    )
    if cfg.model == "memflow":
        model = MemFlowNet(memory_capacity=cfg.memory_capacity, use_rope=cfg.use_rope, **kw)
    else:
        model = (BOFNet if cfg.architecture == "bof" else MOFNet)(**kw)
    return model.to(device=dev, dtype=dtype or default_compute_dtype(dev)).eval()


def init_random_(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the CPU in f32 so every device and
    dtype gets the same values: conv/linear weights and biases
    U(+-1/sqrt(fan_in)) (PyTorch's default bounds), LayerNorm and GroupNorm
    ones/zeros,
    the learned hidden-state init N(0, 1), and GMA's gamma U(0, 1) — upstream
    initializes gamma to 0, which would drop the aggregation from the flows
    of a random-weight run."""
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, lo, hi):
        return torch.empty(shape).uniform_(lo, hi, generator=gen)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(draw(mod.weight.shape, -bound, bound))
                if mod.bias is not None:
                    mod.bias.copy_(draw(mod.bias.shape, -bound, bound))
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("init_hidden_state"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif name.endswith("aggregator.gamma"):
                p.copy_(draw(p.shape, 0.0, 1.0))


class _Fetch:
    """A device tensor's copy to the host, queued behind the work that makes
    it: into pinned memory without blocking, with an event, on the card;
    the tensor itself on the CPU.  `result()` waits for this copy alone."""

    def __init__(self, x: torch.Tensor):
        self.event = None
        if x.device.type == "cuda":
            count("engine.fetch_bytes", x.numel() * x.element_size())
            # On x's card: its stream holds the copy and the event (a mesh's
            # replicas run on cards other than the current one).
            with torch.cuda.device(x.device):
                self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                self.host.copy_(x, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.host = x

    @span("tpuflow.engine.fetch_wait")
    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    @span("tpuflow.engine.deliver")
    def deliver(self, out: np.ndarray) -> None:
        """Wait for the copy and store it in `out` (host memory the caller
        returns)."""
        out[...] = self.result()


def _gather(fetches: List[_Fetch]) -> np.ndarray:
    """The replicas' fetched shards, concatenated in slot order."""
    if len(fetches) == 1:
        return fetches[0].result()
    return np.concatenate([f.result() for f in fetches])


class _FetchAll:
    """The fetches of one dispatch's shards; `result()` concatenates them."""

    def __init__(self, fetches: List[_Fetch]):
        self.fetches = fetches

    def result(self) -> np.ndarray:
        return _gather(self.fetches)


@span("tpuflow.engine.upload.copy")
def _copy_frames(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """Frames as they are, made contiguous on the host and copied to `device`:
    to a card through pinned memory, queued behind the card's work (a copy
    from pageable memory would wait for that work, and the card would then
    idle while the host queues the next)."""
    frames = np.ascontiguousarray(frames)
    count("engine.upload_bytes", frames.nbytes)
    host = torch.from_numpy(frames)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


@span("tpuflow.engine.upload.prep")
def _prep_frames(x: torch.Tensor) -> torch.Tensor:
    """Uploaded frames -> f32 in [0, 1], edge-padded to a multiple of 8."""
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    return pad_frames_edge(x, pad_dims(x.shape[1], x.shape[2], 8))


class FlowEngine:
    """Optical-flow engine for VideoFlow (MOF and BOF) and MemFlow on one
    device, or over the 'data' axis of a mesh."""

    def __init__(
        self,
        config: ModelConfig,
        encoder: Optional[str] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        dense_lookup: str = "auto",
        mesh: Optional[Mesh] = None,
    ):
        """`params`: a state dict with upstream names, or a native checkpoint's
        (loaded by load_model).  `device`: 'cuda' (default) or 'cpu'; with a
        `mesh`, its first 'data' slot's device.  `dtype`: compute dtype
        (default bf16 on the card, f32 on the CPU).  `dense_lookup`: see
        build_model.  `mesh`: split batched dispatches over its 'data' axis
        (module docstring)."""
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(mesh.data_devices()[0] if mesh is not None else device)
        self.model = build_model(config, encoder, dtype, self.device, dense_lookup)
        self.params = params
        self.seed = seed
        self._loaded = False
        self._replicas: Optional[List] = None
        # MemFlow: the memory after the last stream_flows call, on the device.
        self.memory = None

    def load_model(
        self, checkpoint_path: Optional[str] = None, allow_random_init: bool = False
    ) -> str:
        """Load weights: `params` given at construction, else the checkpoint
        at `checkpoint_path` (default: the config's checkpoint path), routed
        by its suffix as the JAX engine routes it (`.msgpack` / `.tpuflow`:
        the native format of runtime/checkpoint.py; anything else a torch
        `.pth`), else —
        only with `allow_random_init=True` or a RANDOM_INIT or
        BENCH_RANDOM_INIT sentinel — seeded random weights (`init_params`).
        A missing checkpoint raises."""
        self._replicas = None
        if self.params is not None:
            self.model.load_state_dict(self.params, strict=True)
            self._loaded = True
            return "preloaded"
        if checkpoint_path in (RANDOM_INIT, BENCH_RANDOM_INIT):
            checkpoint_path, allow_random_init = None, True
        path = checkpoint_path or self.config.checkpoint_path
        if path and os.path.exists(path):
            if is_native_checkpoint(path):
                # The JAX package's native file (runtime/checkpoint.py),
                # validated against this model's names and shapes.
                state = load_params(path, self.model.state_dict())
            else:
                ignore = MEMFLOW_IGNORE if self.config.model == "memflow" else VIDEOFLOW_IGNORE
                state = load_torch_state_dict(path, ignore)
            self.model.load_state_dict(state, strict=True)
            self._loaded = True
            return path
        if not allow_random_init:
            raise FileNotFoundError(
                f"Model file not found: {path}. Download the checkpoint or "
                "pass allow_random_init=True to run with random weights "
                "(outputs will be meaningless)."
            )
        self.model.load_state_dict(self.init_params(), strict=True)
        self._loaded = True
        return f"random-init (checkpoint not found: {path})"

    def init_params(self, h: int = 64, w: int = 64) -> Dict[str, torch.Tensor]:
        """Seeded random weights as a state dict in the model's devices and
        dtypes, without loading them: the weights that load_model's random
        init loads (init_random_, drawn on the CPU in f32).  h and w are the
        JAX package's init frame size (tpuflow/runtime/engine.py:185); the
        port's weights do not depend on one."""
        model = copy.deepcopy(self.model).to(device="cpu", dtype=torch.float32)
        init_random_(model, self.seed)
        ref = self.model.state_dict()
        return {k: v.to(device=ref[k].device, dtype=ref[k].dtype) for k, v in model.state_dict().items()}

    def is_model_loaded(self) -> bool:
        return self._loaded

    def _require_loaded(self) -> None:
        if not self._loaded:
            raise RuntimeError("Model not loaded. Call load_model() first.")

    def get_model_info(self) -> dict:
        """Introspection (videoflow_core.py:204-242 parity)."""
        if not self._loaded:
            return {"status": "not_loaded"}
        return {
            "status": "loaded",
            "model_path": self.config.checkpoint_path,
            "dataset": self.config.dataset,
            "architecture": self.config.architecture.upper(),
            "variant": self.config.variant,
            "config": {
                "decoder_depth": self.config.decoder_depth,
                "corr_levels": self.config.corr_levels,
                "corr_radius": self.config.corr_radius,
            },
            "fast_mode": self.config.fast_mode,
            "sequence_length": self.config.sequence_length,
        }

    def get_memory_usage(self) -> dict:
        """{card: {allocated_mb, limit_mb}} for every visible card, or every
        card of the mesh (torch.cuda.memory_allocated, and the card's total
        from mem_get_info), the JAX engine's keys; an engine on the CPU gets
        the JAX engine's message for a backend without memory statistics."""
        if self.device.type != "cuda":
            return {"message": "Memory tracking not available on this backend"}
        cards = range(torch.cuda.device_count())
        if self.mesh is not None:
            cards = sorted({d.index for d, _ in self._slots()})
        out = {}
        for i in cards:
            _, total = torch.cuda.mem_get_info(i)
            out[f"cuda:{i}"] = {
                "allocated_mb": torch.cuda.memory_allocated(i) / 1024**2,
                "limit_mb": total / 1024**2,
            }
        return out

    def _slots(self) -> List:
        """[(device, model)] per slot of the mesh's 'data' axis, the first
        this engine's model, the others its copies, made at the first
        dispatch after load_model; [(device, model)] without a mesh."""
        if self.mesh is None:
            return [(self.device, self.model)]
        if self._replicas is None:
            devs = [resolve_device(d) for d in self.mesh.data_devices()]
            # Copied as normal tensors, also from inside an inference-mode
            # entry: inference tensors take other CPU kernels.
            with torch.inference_mode(False):
                self._replicas = [(devs[0], self.model)] + [(d, copy.deepcopy(self.model).to(d)) for d in devs[1:]]
        return self._replicas

    def _data_axis(self) -> int:
        """Slots of the mesh's 'data' axis (1 without a mesh)."""
        return 1 if self.mesh is None else len(self.mesh.data_devices())

    def _pad_to_axis(self, rows: np.ndarray):
        """rows padded along dim 0 to a multiple of the data axis by
        repeating the last row (tpuflow/runtime/engine.py:452-459) -> (rows,
        the number of padded rows)."""
        pad = (-len(rows)) % self._data_axis()
        if pad:
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad, 0)])
        return rows, pad

    @span("tpuflow.engine.upload")
    def _upload(self, frames: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
        """Frames [M, h, w, 3] (uint8 0..255 or float 0..1) -> f32 [M, ph,
        pw, 3] in [0, 1] on `device` (default the engine's), edge-padded to a
        multiple of 8."""
        return _prep_frames(_copy_frames(frames, device or self.device))

    def _window_flows_all(self, windows: np.ndarray) -> np.ndarray:
        """Untiled forward: windows [B, T, h, w, 3] (uint8 0..255 or float
        0..1) -> forward flows of ALL interior frames [B, T-2, h, w, 2].  The
        windows split over the replicas (B a multiple of the data axis)."""
        b, t, h, w = windows.shape[:4]
        pt, _, pl, _ = pad_dims(h, w, 8)
        fetches = []
        for (dev, model), rows in zip(self._slots(), split_batch(windows, self._data_axis())):
            x = self._upload(rows.reshape(-1, h, w, 3), dev)
            up_fwd, _ = model(x.reshape(len(rows), t, *x.shape[1:]))
            fetches.append(_Fetch(up_fwd[:, :, pt : pt + h, pl : pl + w]))
        return _gather(fetches)

    def compute_flow(self, frames: Sequence[np.ndarray], frame_idx: int) -> np.ndarray:
        """Forward flow [H, W, 2] of frame `frame_idx` from its centred window
        of whole frames (flow_inference.py:24 contract)."""
        return self.compute_flow_batch(frames, [frame_idx])[0]

    @torch.inference_mode()
    def compute_flow_batch(
        self, frames: Sequence[np.ndarray], frame_indices: Sequence[int]
    ) -> np.ndarray:
        """[len(frame_indices), H, W, 2]: one centred window per requested
        frame, all windows in one batch, the middle interior flow of each.
        MemFlow: per requested frame, the last two frames of its trailing
        window on an empty memory."""
        self._require_loaded()
        arr = np.asarray(frames)
        t = self.config.sequence_length
        if self.config.model == "memflow":
            n, h, w = arr.shape[:3]
            pt, _, pl, _ = pad_dims(h, w, 8)
            out = []
            for idx in frame_indices:
                pair = self._upload(arr[trailing_window_indices(n, idx, max(2, t))[-2:]])
                flow, _, _ = self.model(pair[None], self.model.empty_memory(1, pair.shape[1], pair.shape[2]))
                out.append(flow[0, pt : pt + h, pl : pl + w].cpu().numpy())
                count("engine.frames")
            return np.stack(out)
        wins = np.stack([centered_window_indices(len(arr), i, t) for i in frame_indices])
        windows, pad = self._pad_to_axis(arr[wins])
        flows = self._window_flows_all(windows)
        count("engine.frames", len(frame_indices))
        return flows[: len(flows) - pad, flows.shape[1] // 2]

    @torch.inference_mode()
    def compute_flows_strided(
        self, frames: Sequence[np.ndarray], window_batch: int = 2
    ) -> np.ndarray:
        """Flows [N, H, W, 2] for every frame at interior stride: windows start
        at -1, T-3, 2T-5, ... (indices clipped to the clip) and every interior
        flow is kept, so T-2 times fewer windows run than at stride 1.
        Batches hold `window_batch` windows; the last one holds what is
        left.  Under a mesh window_batch is rounded up to a multiple of the
        data axis (tpuflow/runtime/engine.py:305-313) and the last batch
        padded to one.  A VideoFlow mode."""
        if self.config.model == "memflow":
            raise ValueError("compute_flows_strided is a VideoFlow mode; MemFlow streams with stream_flows")
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        t = self.config.sequence_length
        stride = t - 2
        starts = list(range(-1, n - 1, stride))
        window_batch += (-window_batch) % self._data_axis()
        flows = np.empty((n, h, w, 2), np.float32)
        for b0 in range(0, len(starts), window_batch):
            chunk = starts[b0 : b0 + window_batch]
            idx = np.stack([np.clip(np.arange(a, a + t), 0, n - 1) for a in chunk])
            out = self._window_flows_all(self._pad_to_axis(arr[idx])[0])
            for j, a in enumerate(chunk):
                for k in range(stride):
                    if 0 <= a + 1 + k < n:
                        flows[a + 1 + k] = out[j, k]
        count("engine.frames", n)
        return flows

    def _tile_features(self, frame: np.ndarray, tiles_info, idxs, overlap: int, slot=None):
        """One frame's tiles of one shape group -> (feats, ctx), each
        [G, h8, w8, 256], by the model of `slot` (device, model) on its
        device (default the engine's)."""
        dev, model = slot or (self.device, self.model)
        tiles = extract_tile_group(frame[None], tiles_info, idxs, overlap)[:, 0]
        count("engine.tiles", len(idxs))
        return model.frame_features(self._upload(tiles, dev))

    def _middle_flow(self, up_fwd: torch.Tensor, th: int, tw: int) -> torch.Tensor:
        """Forward flows of the interior frames [B, T-2, H8, W8, 2] -> the
        middle one's, with the padding to a multiple of 8 cropped away: [B,
        th, tw, 2]."""
        pt, _, pl, _ = pad_dims(th, tw, 8)
        return up_fwd[:, (self.config.sequence_length - 2) // 2, pt : pt + th, pl : pl + tw]

    def _window_flow(self, feats: torch.Tensor, ctxs: torch.Tensor, th: int, tw: int, model=None) -> torch.Tensor:
        """Per-frame features of windows stacked on the batch axis (feats and
        ctxs [B, T, h8, w8, C]) -> the middle interior frame's forward flow
        per batch row [B, th, tw, 2], on their device, by `model` (default
        the engine's)."""
        model = model or self.model
        up_fwd, _ = model.refine(model.encode_from_features(feats, ctxs))
        return self._middle_flow(up_fwd, th, tw)

    def _tiling(self, h: int, w: int, tile_size: int):
        _, _, _, _, tiles_info = calculate_tile_grid(
            w, h, tile_size, layout=resolve_tile_layout()
        )
        return tiles_info, group_tiles_by_shape(tiles_info)

    @torch.inference_mode()
    def compute_flow_tiled(
        self,
        frames: Sequence[np.ndarray],
        frame_idx: int,
        tile_size: int = TILE_SIZE,
        overlap: int = 0,
        tile_batch: int = 4,
    ) -> np.ndarray:
        """Tile-mode forward flow [H, W, 2] of frame `frame_idx` from its
        centred window, each shape group's tiles `tile_batch` at a time (the
        last chunk holds what is left).  Under a mesh tile_batch is rounded
        up to a multiple of the data axis and each chunk padded to one
        (tpuflow/runtime/engine.py:490-510), and each replica computes the
        features and the flows of its tiles.  A frame that fits one tile,
        and any MemFlow frame, is compute_flow's."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        if self.config.model == "memflow" or (h <= tile_size and w <= tile_size):
            return self.compute_flow(arr, frame_idx)
        tiles_info, groups = self._tiling(h, w, tile_size)
        win = centered_window_indices(n, frame_idx, self.config.sequence_length)
        tile_batch += (-tile_batch) % self._data_axis()
        tile_flows: List = [None] * len(tiles_info)
        for (th, tw), idxs in groups.items():
            ph, pw = th + 2 * overlap, tw + 2 * overlap
            group_flows = np.empty((len(idxs), ph, pw, 2), np.float32)
            for c0 in range(0, len(idxs), tile_batch):
                chunk = idxs[c0 : c0 + tile_batch]
                padded, _ = self._pad_to_axis(np.asarray(chunk))
                fetches = []
                for slot, shard in zip(self._slots(), split_batch(padded, self._data_axis())):
                    per_frame = {f: self._tile_features(arr[f], tiles_info, [int(i) for i in shard], overlap, slot)
                                 for f in set(win)}
                    feats = torch.stack([per_frame[f][0] for f in win], 1)
                    ctxs = torch.stack([per_frame[f][1] for f in win], 1)
                    fetches.append(_Fetch(self._window_flow(feats, ctxs, ph, pw, slot[1])))
                group_flows[c0 : c0 + len(chunk)] = _gather(fetches)[: len(chunk)]
            for j, ti in enumerate(idxs):
                tile_flows[ti] = group_flows[j]
        count("engine.frames")
        with PASTE_SPAN:
            return paste_tile_flows(tile_flows, tiles_info, w, h, tile_size, overlap)

    def _clamp_window_batch(self, wb: int, t: int, groups) -> int:
        """The stride-1 window batch, clamped so that one batch's dense
        correlation volumes (2 directions x T-2 interiors x the tiles of a
        shape group, per window) fit the budget: TPUFLOW_WB_HBM_BUDGET bytes
        if set, else on the card its free memory (as CUDA reports it, and what
        PyTorch's allocator holds unused) less WB_ACTIVATION_SHARE of it; on
        the CPU nothing is clamped without the override.  Paths that
        keep no volumes (FlashCorr2, 'auto' above the materialization
        threshold) are not clamped.  As tpuflow/runtime/engine.py:614, with
        the port's own volume layout (core/corr.py dense_volume_bytes; its
        band layout is as large as the dense one).  Under a mesh the budget
        holds per card, shared by the replicas on it, and the batch stays a
        multiple of the data axis."""
        slots = self._data_axis()
        if wb <= slots:
            return wb
        env = os.environ.get(WB_BUDGET_ENV)
        if env is None and self.device.type != "cuda":
            return wb
        devices = [dev for dev, _ in self._slots()]
        budgets = []
        for dev in devices:
            if env is not None:
                card = float(env)
            else:
                free, _ = torch.cuda.mem_get_info(dev)
                free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
                card = free * (1.0 - WB_ACTIVATION_SHARE)
            budgets.append(card / devices.count(dev))
        budget = min(budgets)
        impl, model = self.config.corr_impl, self.model
        worst = 0
        for (th, tw), idxs in groups.items():
            h8, w8 = -(-th // 8), -(-tw // 8)
            materializes = impl in ("dense", "materialized", "band") or (
                impl == "auto" and h8 * w8 <= model.materialize_threshold
            )
            if materializes:
                per_win = 2 * (t - 2) * len(idxs) * dense_volume_bytes(h8, w8, model.corr_levels, model.corr_dtype)
                worst = max(worst, per_win)
        if worst == 0:
            return wb
        fit = max(1, int(budget // worst)) * slots
        if fit < wb:
            print(
                f"[tpuflow] window_batch {wb} -> {fit}: dense correlation volumes are "
                f"~{worst / 1e9:.1f} GB per window and must fit device memory (budget "
                f"{budget / 1e9:.0f} GB; override via {WB_BUDGET_ENV} or corr_impl='flash2')."
            )
            return fit
        return wb

    @torch.inference_mode()
    def compute_flows_tiled_stride1(
        self,
        frames: Sequence[np.ndarray],
        tile_size: int = TILE_SIZE,
        overlap: int = 0,
        progress_cb=None,
        window_batch: int = 1,
    ) -> np.ndarray:
        """Stride-1 tile-mode flows [N, H, W, 2] for every frame: the same
        outputs as compute_flow_tiled per frame, with each frame's per-tile
        encoder features computed once (consecutive windows share T-1 of
        their T frames).  `window_batch` windows run as one batch (clamped,
        see _clamp_window_batch); a batch's flows are fetched and pasted
        after the next batch has been queued.  A clip whose frames fit one
        tile, and a MemFlow clip, runs compute_flow per frame.
        `progress_cb(i, flow)` is called with each frame's flow as it is
        pasted, in frame order.  Under a mesh window_batch is at least the
        data axis and a multiple of it, the last batch is padded with its
        last window (tpuflow/runtime/engine.py:697-709, :752-756), each
        frame's features are computed once on the first slot, and each
        replica refines its share of the batch's windows."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        t = self.config.sequence_length
        if self.config.model == "memflow" or (h <= tile_size and w <= tile_size):
            # progress_cb as on the tiled route (the JAX engine calls none
            # here, so its pipeline's --tile fails on such clips).
            flows_out = np.empty((n, h, w, 2), np.float32)
            for i in range(n):
                flows_out[i] = self.compute_flow_tiled(arr, i, tile_size, overlap)
                if progress_cb is not None:
                    progress_cb(i, flows_out[i])
            return flows_out
        wb = max(1, window_batch)
        d = self._data_axis()
        if self.mesh is not None:
            wb = max(wb, d) + (-max(wb, d)) % d
        tiles_info, groups = self._tiling(h, w, tile_size)
        wb = self._clamp_window_batch(wb, t, groups)
        caches: Dict = {shape: {} for shape in groups}
        flows_out = np.empty((n, h, w, 2), np.float32)

        def finalize(outs, group_flows):
            tile_flows: List[List] = [[None] * len(tiles_info) for _ in outs]
            for idxs, fetched in group_flows:
                host = fetched.result()
                for k in range(len(outs)):
                    for j, ti in enumerate(idxs):
                        tile_flows[k][ti] = host[k * len(idxs) + j]
            for k, i in enumerate(outs):
                with PASTE_SPAN:
                    flows_out[i] = paste_tile_flows(tile_flows[k], tiles_info, w, h, tile_size, overlap)
                count("engine.frames")
                if progress_cb is not None:
                    progress_cb(i, flows_out[i])

        pending = None
        for i0 in range(0, n, wb):
            outs = list(range(i0, min(n, i0 + wb)))
            wins = [centered_window_indices(n, i, t) for i in outs]
            if self.mesh is not None and len(wins) % d:
                # Padded windows repeat the last one; finalize reads only
                # the rows of `outs`.
                wins += [wins[-1]] * (-len(wins) % d)
            group_flows = []
            for (th, tw), idxs in groups.items():
                cache = caches[(th, tw)]
                for f in dict.fromkeys(f for win in wins for f in win):
                    if f not in cache:
                        cache[f] = self._tile_features(arr[f], tiles_info, idxs, overlap)
                # Frames below i0 - t can no longer appear in a window.
                for f in [f for f in cache if f < max(0, i0 - t)]:
                    del cache[f]
                # Window-major: window k's tiles are batch rows k*G .. k*G+G-1.
                feats = torch.cat([torch.stack([cache[f][0] for f in win], 1) for win in wins])
                ctxs = torch.cat([torch.stack([cache[f][1] for f in win], 1) for win in wins])
                # Whole windows per replica: len(wins) is a multiple of d.
                fetches = []
                for (dev, model), f_s, c_s in zip(self._slots(), split_batch(feats, d), split_batch(ctxs, d)):
                    flows = self._window_flow(f_s.to(dev), c_s.to(dev), th + 2 * overlap, tw + 2 * overlap, model)
                    fetches.append(_Fetch(flows))
                group_flows.append((idxs, _FetchAll(fetches)))
            # One batch deep: this batch is queued before the last one's
            # flows are waited for and pasted.
            if pending is not None:
                finalize(*pending)
            pending = (outs, group_flows)
        if pending is not None:
            finalize(*pending)
        return flows_out

    @torch.inference_mode()
    def stream_flows(self, frames: Sequence[np.ndarray], warm_start: bool = False) -> np.ndarray:
        """MemFlow streaming: flows [N, H, W, 2], frame i's from the pair
        (max(i-1, 0), i), with the memory carried across the whole clip
        (frame 0 pairs with itself on an empty memory).  `warm_start`: each
        frame starts from the previous frame's 1/8-resolution flow, clamped
        to +-CARRY_CLAMP.  Frames go to the device one at a time; a frame's
        flow is fetched while the next one runs.  The memory after the last
        frame stays in `self.memory`.  (The JAX engine's `chunk` argument,
        which it reads nowhere, has no counterpart.)"""
        if self.config.model != "memflow":
            raise ValueError("stream_flows is a MemFlow mode")
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        pt, _, pl, _ = pad_dims(h, w, 8)
        flows = np.empty((n, h, w, 2), np.float32)
        memory = prev = low = pending = None
        for i in range(n):
            cur = self._upload(arr[i : i + 1])
            if memory is None:
                memory, prev = self.model.empty_memory(1, cur.shape[1], cur.shape[2]), cur
            flow, memory, low = self.model(torch.cat([prev, cur])[None], memory, low if warm_start else None)
            low = low.clamp(-CARRY_CLAMP, CARRY_CLAMP)
            fetched = _Fetch(flow[0, pt : pt + h, pl : pl + w])
            if pending is not None:
                pending[1].deliver(flows[pending[0]])
            pending, prev = (i, fetched), cur
            count("engine.frames")
        if pending is not None:
            pending[1].deliver(flows[pending[0]])
        self.memory = memory
        return flows
