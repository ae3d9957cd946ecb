"""FlowEngine: the port's inference engine, main-path subset of
tpuflow/runtime/engine.py.

- `compute_flows_tiled_stride1`: flows for every frame of a clip, one
  centred window per output frame (reference stride-1 semantics,
  videoflow_core.py:193-195), tiles batched per shape group, each frame's
  per-tile encoder features computed once and kept in a rolling cache.
- `compute_flow_tiled`: one frame's flow in tile mode.

Both pad tiles to a multiple of 8 with edge replication, run MOFNet, keep
the middle interior frame's forward flow and paste the tiles back
(reference hard paste).  Numpy in, numpy out.  Runs on the card unless
the caller passes device='cpu'.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import TILE_SIZE, ModelConfig
from ..core.mofnet import MOFNet
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


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (as engine.py:57-63)."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def build_model(
    cfg: ModelConfig,
    encoder: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> MOFNet:
    """MOFNet for `cfg` on `device` in `dtype` (default: bf16 on the card,
    f32 on the CPU), parameters uninitialized until loaded."""
    dev = resolve_device(device)
    if cfg.model != "videoflow" or cfg.architecture != "mof":
        raise NotImplementedError(
            f"{cfg.model}/{cfg.architecture}: only VideoFlow MOF is ported; "
            "BOFNet and MemFlow are later slices of the port (see ROADMAP.md)."
        )
    model = MOFNet(
        corr_levels=cfg.corr_levels,
        corr_radius=cfg.corr_radius,
        decoder_depth=cfg.decoder_depth,
        feature_dim=cfg.feature_dim,
        hidden_dim=cfg.hidden_dim,
        context_dim=cfg.context_dim,
        encoder=encoder or cfg.encoder,
        corr_impl=cfg.corr_impl,
    )
    return model.to(device=dev, dtype=dtype or default_compute_dtype(dev)).eval()


def init_random_(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the CPU in f32 so every device and
    dtype gets the same values: conv/linear weights and biases
    U(+-1/sqrt(fan_in)) (PyTorch's default bounds), LayerNorm ones/zeros,
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
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("init_hidden_state"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif name.endswith("aggregator.gamma"):
                p.copy_(draw(p.shape, 0.0, 1.0))


class FlowEngine:
    """Optical-flow engine for VideoFlow MOF on one device."""

    def __init__(
        self,
        config: ModelConfig,
        encoder: Optional[str] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        """`params`: a state dict with upstream names (loaded by load_model).
        `device`: 'cuda' (default) or 'cpu'.  `dtype`: compute dtype
        (default bf16 on the card, f32 on the CPU)."""
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config, encoder, dtype, self.device)
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

    def _tile_features(self, frame: np.ndarray, tiles_info, idxs, overlap: int):
        """One frame's tiles of one shape group -> (feats, ctx), each
        [G, h8, w8, 256] on the device."""
        tiles = extract_tile_group(frame[None], tiles_info, idxs, overlap)[:, 0]
        x = torch.from_numpy(tiles).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        x = pad_frames_edge(x, pad_dims(x.shape[1], x.shape[2], 8))
        return self.model.frame_features(x)

    def _window_flow(self, feats: Sequence, ctxs: Sequence, th: int, tw: int) -> np.ndarray:
        """Per-frame features of one window (T entries of [G, h8, w8, C]) ->
        the middle interior frame's forward flow per tile [G, th, tw, 2]."""
        pt, _, pl, _ = pad_dims(th, tw, 8)
        mid = (self.config.sequence_length - 2) // 2
        enc = self.model.encode_from_features(torch.stack(feats, 1), torch.stack(ctxs, 1))
        up_fwd, _ = self.model.refine(enc)
        return up_fwd[:, mid, pt : pt + th, pl : pl + tw].cpu().numpy()

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
    ) -> np.ndarray:
        """Tile-mode forward flow [H, W, 2] of frame `frame_idx` from its
        centred window."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        tiles_info, groups = self._tiling(h, w, tile_size)
        win = centered_window_indices(n, frame_idx, self.config.sequence_length)
        tile_flows: List = [None] * len(tiles_info)
        for (th, tw), idxs in groups.items():
            per_frame = {f: self._tile_features(arr[f], tiles_info, idxs, overlap) for f in set(win)}
            flows = self._window_flow(
                [per_frame[f][0] for f in win], [per_frame[f][1] for f in win],
                th + 2 * overlap, tw + 2 * overlap,
            )
            for j, ti in enumerate(idxs):
                tile_flows[ti] = flows[j]
        return paste_tile_flows(tile_flows, tiles_info, w, h, tile_size, overlap)

    @torch.inference_mode()
    def compute_flows_tiled_stride1(
        self,
        frames: Sequence[np.ndarray],
        tile_size: int = TILE_SIZE,
        overlap: int = 0,
        progress_cb=None,
    ) -> np.ndarray:
        """Stride-1 tile-mode flows [N, H, W, 2] for every frame: the same
        outputs as compute_flow_tiled per frame, with each frame's per-tile
        encoder features computed once (consecutive windows share T-1 of
        their T frames)."""
        self._require_loaded()
        arr = np.asarray(frames)
        n, h, w = arr.shape[:3]
        t = self.config.sequence_length
        tiles_info, groups = self._tiling(h, w, tile_size)
        caches: Dict = {shape: {} for shape in groups}
        flows_out = np.empty((n, h, w, 2), np.float32)
        for i in range(n):
            win = centered_window_indices(n, i, t)
            tile_flows: List = [None] * len(tiles_info)
            for (th, tw), idxs in groups.items():
                cache = caches[(th, tw)]
                for f in dict.fromkeys(win):
                    if f not in cache:
                        cache[f] = self._tile_features(arr[f], tiles_info, idxs, overlap)
                # Frames below this window's start never appear again.
                for f in [f for f in cache if f < win[0]]:
                    del cache[f]
                flows = self._window_flow(
                    [cache[f][0] for f in win], [cache[f][1] for f in win],
                    th + 2 * overlap, tw + 2 * overlap,
                )
                for j, ti in enumerate(idxs):
                    tile_flows[ti] = flows[j]
            flows_out[i] = paste_tile_flows(tile_flows, tiles_info, w, h, tile_size, overlap)
            if progress_cb is not None:
                progress_cb(i, flows_out[i])
        return flows_out
