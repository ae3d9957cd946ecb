"""FlowEngine: the port's inference engine, the VideoFlow (MOF and BOF) part
of tpuflow/runtime/engine.py.

- `compute_flows_tiled_stride1`: flows for every frame of a clip, one
  centred window per output frame (reference stride-1 semantics,
  videoflow_core.py:193-195), tiles batched per shape group, each frame's
  per-tile encoder features computed once and kept in a rolling cache.
  `window_batch` windows stack window-major along the tile batch (clamped
  so that their correlation volumes fit the card, `_clamp_window_batch`),
  and dispatch is pipelined one batch deep: a batch's flows are copied to
  pinned host memory behind its refinement and pasted while the next batch
  runs.  `TPUFLOW_STRIDE1=pairs` selects the pair-cached loop (each frame
  pair's correlation built once), as in the JAX package: the same flows,
  not the default.
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
device='cpu'.  MemFlow is a later slice of the port (`build_model` refuses
it).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import TILE_SIZE, ModelConfig
from ..core.corr import dense_volume_bytes
from ..core.mofnet import BOFNet, MOFNet
from ..core.padding import pad_dims, pad_frames_edge
from .convert import load_torch_state_dict
from .device import resolve_device
from .tiles import (
    calculate_tile_grid,
    extract_tile_group,
    group_tiles_by_shape,
    paste_tile_flows,
    resolve_tile_layout,
)
from .windows import centered_window_indices

# Sentinel checkpoint path: explicit opt-in to seeded random weights.
RANDOM_INIT = "__random_init__"

# Window batching on the card: the correlation volumes of one batch may take
# the card's free memory less this share of it, which is left to the
# refinement's activations (see _clamp_window_batch).  The JAX package's
# override, read under the same name, sets the volumes' budget in bytes.
WB_BUDGET_ENV = "TPUFLOW_WB_HBM_BUDGET"
WB_ACTIVATION_SHARE = 0.25


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (as engine.py:57-63)."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def build_model(
    cfg: ModelConfig,
    encoder: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    dense_lookup: str = "auto",
) -> MOFNet:
    """MOFNet, or BOFNet for architecture 'bof', for `cfg` on `device` in
    `dtype` (default: bf16 on the card, f32 on the CPU), parameters
    uninitialized until loaded.  `encoder=None` follows cfg.encoder
    ('twins' or 'cnn').  `dense_lookup`: how a DenseCorrPyramid is looked up
    ('auto' = the fused kernel K1; see MOFNet)."""
    dev = resolve_device(device)
    if cfg.model != "videoflow":
        raise NotImplementedError(
            f"{cfg.model}: only VideoFlow (MOF and BOF) is ported; MemFlow is a "
            "later slice of the port (see ROADMAP.md)."
        )
    cls = BOFNet if cfg.architecture == "bof" else MOFNet
    model = cls(
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
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = x

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class FlowEngine:
    """Optical-flow engine for VideoFlow (MOF and BOF) on one device."""

    def __init__(
        self,
        config: ModelConfig,
        encoder: Optional[str] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        dense_lookup: str = "auto",
    ):
        """`params`: a state dict with upstream names (loaded by load_model).
        `device`: 'cuda' (default) or 'cpu'.  `dtype`: compute dtype
        (default bf16 on the card, f32 on the CPU).  `dense_lookup`: see
        build_model."""
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config, encoder, dtype, self.device, dense_lookup)
        self.params = params
        self.seed = seed
        self._loaded = False

    def load_model(
        self, checkpoint_path: Optional[str] = None, allow_random_init: bool = False
    ) -> str:
        """Load weights: `params` given at construction, else a `.pth` at
        `checkpoint_path` (default: the config's checkpoint path), else —
        only with `allow_random_init=True` or the RANDOM_INIT sentinel —
        seeded random weights.  A missing checkpoint raises."""
        if self.params is not None:
            self.model.load_state_dict(self.params, strict=True)
            self._loaded = True
            return "preloaded"
        if checkpoint_path == RANDOM_INIT:
            checkpoint_path, allow_random_init = None, True
        path = checkpoint_path or self.config.checkpoint_path
        if path and os.path.exists(path):
            self.model.load_state_dict(load_torch_state_dict(path), strict=True)
            self._loaded = True
            return path
        if not allow_random_init:
            raise FileNotFoundError(
                f"Model file not found: {path}. Download the checkpoint or "
                "pass allow_random_init=True to run with random weights "
                "(outputs will be meaningless)."
            )
        dev, dt = self.device, self.model.dtype
        init_random_(self.model.float().cpu(), self.seed)
        self.model.to(device=dev, dtype=dt)
        self._loaded = True
        return f"random-init (checkpoint not found: {path})"

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
        """{card: {allocated_mb, limit_mb}} for every visible card
        (torch.cuda.memory_allocated, and the card's total from
        mem_get_info), the JAX engine's keys; an engine on the CPU gets the
        JAX engine's message for a backend without memory statistics."""
        if self.device.type != "cuda":
            return {"message": "Memory tracking not available on this backend"}
        out = {}
        for i in range(torch.cuda.device_count()):
            _, total = torch.cuda.mem_get_info(i)
            out[f"cuda:{i}"] = {
                "allocated_mb": torch.cuda.memory_allocated(i) / 1024**2,
                "limit_mb": total / 1024**2,
            }
        return out

    def _window_flows_all(self, windows: np.ndarray) -> np.ndarray:
        """Untiled forward: windows [B, T, h, w, 3] (uint8 0..255 or float
        0..1) -> forward flows of ALL interior frames [B, T-2, h, w, 2]."""
        b, t, h, w = windows.shape[:4]
        pads = pad_dims(h, w, 8)
        pt, _, pl, _ = pads
        x = torch.from_numpy(windows).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        x = pad_frames_edge(x.reshape(b * t, h, w, 3), pads)
        up_fwd, _ = self.model(x.reshape(b, t, *x.shape[1:]))
        return up_fwd[:, :, pt : pt + h, pl : pl + w].cpu().numpy()

    def compute_flow(self, frames: Sequence[np.ndarray], frame_idx: int) -> np.ndarray:
        """Forward flow [H, W, 2] of frame `frame_idx` from its centred window
        of whole frames (flow_inference.py:24 contract)."""
        return self.compute_flow_batch(frames, [frame_idx])[0]

    @torch.inference_mode()
    def compute_flow_batch(
        self, frames: Sequence[np.ndarray], frame_indices: Sequence[int]
    ) -> np.ndarray:
        """[len(frame_indices), H, W, 2]: one centred window per requested
        frame, all windows in one batch, the middle interior flow of each."""
        self._require_loaded()
        arr = np.asarray(frames)
        t = self.config.sequence_length
        wins = np.stack([centered_window_indices(len(arr), i, t) for i in frame_indices])
        flows = self._window_flows_all(arr[wins])
        return flows[:, flows.shape[1] // 2]

    @torch.inference_mode()
    def compute_flows_strided(
        self, frames: Sequence[np.ndarray], window_batch: int = 2
    ) -> np.ndarray:
        """Flows [N, H, W, 2] for every frame at interior stride: windows start
        at -1, T-3, 2T-5, ... (indices clipped to the clip) and every interior
        flow is kept, so T-2 times fewer windows run than at stride 1.
        Batches hold `window_batch` windows; the last one holds what is
        left."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        t = self.config.sequence_length
        stride = t - 2
        starts = list(range(-1, n - 1, stride))
        flows = np.empty((n, h, w, 2), np.float32)
        for b0 in range(0, len(starts), window_batch):
            chunk = starts[b0 : b0 + window_batch]
            idx = np.stack([np.clip(np.arange(a, a + t), 0, n - 1) for a in chunk])
            out = self._window_flows_all(arr[idx])
            for j, a in enumerate(chunk):
                for k in range(stride):
                    if 0 <= a + 1 + k < n:
                        flows[a + 1 + k] = out[j, k]
        return flows

    def _tile_features(self, frame: np.ndarray, tiles_info, idxs, overlap: int):
        """One frame's tiles of one shape group -> (feats, ctx), each
        [G, h8, w8, 256] on the device."""
        tiles = extract_tile_group(frame[None], tiles_info, idxs, overlap)[:, 0]
        x = torch.from_numpy(tiles).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        x = pad_frames_edge(x, pad_dims(x.shape[1], x.shape[2], 8))
        return self.model.frame_features(x)

    def _middle_flow(self, up_fwd: torch.Tensor, th: int, tw: int) -> torch.Tensor:
        """Forward flows of the interior frames [B, T-2, H8, W8, 2] -> the
        middle one's, with the padding to a multiple of 8 cropped away: [B,
        th, tw, 2]."""
        pt, _, pl, _ = pad_dims(th, tw, 8)
        return up_fwd[:, (self.config.sequence_length - 2) // 2, pt : pt + th, pl : pl + tw]

    def _window_flow(self, feats: torch.Tensor, ctxs: torch.Tensor, th: int, tw: int) -> torch.Tensor:
        """Per-frame features of windows stacked on the batch axis (feats and
        ctxs [B, T, h8, w8, C]) -> the middle interior frame's forward flow
        per batch row [B, th, tw, 2], on the device."""
        up_fwd, _ = self.model.refine(self.model.encode_from_features(feats, ctxs))
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
        last chunk holds what is left).  A frame that fits one tile is
        compute_flow's."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        if h <= tile_size and w <= tile_size:
            return self.compute_flow(arr, frame_idx)
        tiles_info, groups = self._tiling(h, w, tile_size)
        win = centered_window_indices(n, frame_idx, self.config.sequence_length)
        tile_flows: List = [None] * len(tiles_info)
        for (th, tw), idxs in groups.items():
            ph, pw = th + 2 * overlap, tw + 2 * overlap
            group_flows = np.empty((len(idxs), ph, pw, 2), np.float32)
            for c0 in range(0, len(idxs), tile_batch):
                chunk = idxs[c0 : c0 + tile_batch]
                per_frame = {f: self._tile_features(arr[f], tiles_info, chunk, overlap) for f in set(win)}
                feats = torch.stack([per_frame[f][0] for f in win], 1)
                ctxs = torch.stack([per_frame[f][1] for f in win], 1)
                group_flows[c0 : c0 + len(chunk)] = _Fetch(self._window_flow(feats, ctxs, ph, pw)).result()
            for j, ti in enumerate(idxs):
                tile_flows[ti] = group_flows[j]
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
        band layout is as large as the dense one)."""
        if wb <= 1:
            return wb
        env = os.environ.get(WB_BUDGET_ENV)
        if env is not None:
            budget = float(env)
        elif self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
            budget = free * (1.0 - WB_ACTIVATION_SHARE)
        else:
            return wb
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
        fit = max(1, int(budget // worst))
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
        tile runs compute_flow per frame."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        t = self.config.sequence_length
        if h <= tile_size and w <= tile_size:
            return np.stack([self.compute_flow_tiled(arr, i, tile_size, overlap) for i in range(n)])
        wb = max(1, window_batch)
        if wb == 1 and os.environ.get("TPUFLOW_STRIDE1", "trio") == "pairs":
            # Slower in the JAX package's measurements (tpuflow/runtime/
            # engine.py:710-717); kept for its numerics, as there.
            return self._stride1_pairs_loop(arr, tile_size, overlap, progress_cb)
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
                flows_out[i] = paste_tile_flows(tile_flows[k], tiles_info, w, h, tile_size, overlap)
                if progress_cb is not None:
                    progress_cb(i, flows_out[i])

        pending = None
        for i0 in range(0, n, wb):
            outs = list(range(i0, min(n, i0 + wb)))
            wins = [centered_window_indices(n, i, t) for i in outs]
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
                flows = self._window_flow(feats, ctxs, th + 2 * overlap, tw + 2 * overlap)
                group_flows.append((idxs, _Fetch(flows)))
            # One batch deep: this batch is queued before the last one's
            # flows are waited for and pasted.
            if pending is not None:
                finalize(*pending)
            pending = (outs, group_flows)
        if pending is not None:
            finalize(*pending)
        return flows_out

    def _stride1_pairs_loop(self, arr: np.ndarray, tile_size: int, overlap: int, progress_cb=None) -> np.ndarray:
        """The pair-cached stride-1 loop (tpuflow/runtime/engine.py:820):
        per frame and tile group, the encoders and the prepared context
        (net, inp, q, k) of the window's new frame, the correlation of each
        new frame pair (interior p against p+1 and p-1), and one refinement
        from these caches (MOFNet.refine_pairs), whose lookups run per pair.
        The caches keep exactly this window's frames and pairs.  Pipelined one
        window deep, as the trio loop."""
        n, h, w = arr.shape[:3]
        t = self.config.sequence_length
        model = self.model
        tiles_info, groups = self._tiling(h, w, tile_size)
        fcaches: Dict = {shape: {} for shape in groups}   # f -> (feats, prepared context)
        pcaches: Dict = {shape: {} for shape in groups}   # (a, b) -> correlation object
        flows_out = np.empty((n, h, w, 2), np.float32)

        def finalize(i, group_flows):
            tile_flows: List = [None] * len(tiles_info)
            for idxs, fetched in group_flows:
                host = fetched.result()
                for j, ti in enumerate(idxs):
                    tile_flows[ti] = host[j]
            flows_out[i] = paste_tile_flows(tile_flows, tiles_info, w, h, tile_size, overlap)
            if progress_cb is not None:
                progress_cb(i, flows_out[i])

        pending = None
        for i in range(n):
            win = centered_window_indices(n, i, t)
            fwd_keys = [(win[p], win[p + 1]) for p in range(1, t - 1)]
            bwd_keys = [(win[p], win[p - 1]) for p in range(1, t - 1)]
            group_flows = []
            for (th, tw), idxs in groups.items():
                fc, pc = fcaches[(th, tw)], pcaches[(th, tw)]
                for f in dict.fromkeys(win):
                    if f not in fc:
                        feats, ctx = self._tile_features(arr[f], tiles_info, idxs, overlap)
                        fc[f] = (feats, model.prepare_context(ctx))
                for key in dict.fromkeys(fwd_keys + bwd_keys):
                    if key not in pc:
                        pc[key] = model.pair_corr_state(fc[key[0]][0], fc[key[1]][0])
                for f in [f for f in fc if f not in win]:
                    del fc[f]
                for key in [key for key in pc if key not in fwd_keys and key not in bwd_keys]:
                    del pc[key]
                up_fwd, _ = model.refine_pairs(
                    [fc[win[p]][1] for p in range(1, t - 1)],
                    [pc[key] for key in fwd_keys], [pc[key] for key in bwd_keys],
                )
                flows = self._middle_flow(up_fwd, th + 2 * overlap, tw + 2 * overlap)
                group_flows.append((idxs, _Fetch(flows)))
            if pending is not None:
                finalize(*pending)
            pending = (i, group_flows)
        if pending is not None:
            finalize(*pending)
        return flows_out
