"""Tile-mode grid math, extraction and paste (copy of
tpuflow/runtime/tiles.py).

Grid layout parity with videoflow_processor.py:73-110; the 'balanced'
layout gives every tile of a frame one shape (1920x1080 -> two 960x1080
tiles), so one batched forward covers all tiles of a window.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class TileInfo:
    x: int
    y: int
    width: int
    height: int
    col: int
    row: int


def resolve_tile_layout(layout: str | None = None) -> str:
    """Tile layout: 'balanced' (default) or 'reference'; TPUFLOW_TILE_LAYOUT
    overrides per run."""
    resolved = layout or os.environ.get("TPUFLOW_TILE_LAYOUT", "balanced")
    if resolved not in ("balanced", "reference"):
        raise ValueError(
            f"Unknown tile layout {resolved!r}: expected 'balanced' or "
            "'reference' (check TPUFLOW_TILE_LAYOUT)."
        )
    return resolved


def _uniform_axis(n: int, k: int) -> Tuple[int, List[int]]:
    """One size + k start offsets covering [0, n) with uniform tiles: size is
    ceil(n/k) rounded up to a multiple of 8, offsets spread evenly with the
    last pinned to n - size."""
    if k <= 1:
        return n, [0]
    size = min(n, -(-(-(-n // k)) // 8) * 8)
    span = n - size
    return size, [round(i * span / (k - 1)) for i in range(k)]


def calculate_tile_grid(
    width: int,
    height: int,
    tile_size: int = 1280,
    layout: str = "reference",
) -> Tuple[int, int, int, int, List[dict]]:
    """(tile_w, tile_h, cols, rows, tiles_info) with the reference's dict
    keys.  'reference': fixed squares, shrunken edge tiles.  'balanced': the
    same tile count with equal sizes."""
    if layout not in ("balanced", "reference"):
        raise ValueError(
            f"Unknown tile layout {layout!r}: expected 'balanced' or 'reference'."
        )
    cols = int(np.ceil(width / tile_size))
    rows = int(np.ceil(height / tile_size))
    if layout == "balanced":
        tw, xs = _uniform_axis(width, cols)
        th, ys = _uniform_axis(height, rows)
        tiles_info = [
            {"x": x, "y": y, "width": tw, "height": th, "col": col, "row": row}
            for row, y in enumerate(ys)
            for col, x in enumerate(xs)
        ]
        return tw, th, cols, rows, tiles_info
    tiles_info = []
    for row in range(rows):
        for col in range(cols):
            x = col * tile_size
            y = row * tile_size
            tiles_info.append(
                {
                    "x": x,
                    "y": y,
                    "width": min(tile_size, width - x),
                    "height": min(tile_size, height - y),
                    "col": col,
                    "row": row,
                }
            )
    return tile_size, tile_size, cols, rows, tiles_info


def group_tiles_by_shape(tiles_info: List[dict]) -> dict:
    """Group tile indices by their actual (height, width)."""
    groups: dict = {}
    for i, info in enumerate(tiles_info):
        groups.setdefault((info["height"], info["width"]), []).append(i)
    return groups


def extract_tile(frame: np.ndarray, tile_info: dict) -> np.ndarray:
    """Crop without padding (videoflow_processor.py:112-120)."""
    x, y = tile_info["x"], tile_info["y"]
    w, h = tile_info["width"], tile_info["height"]
    return frame[y : y + h, x : x + w]


def extract_tile_group(
    frames: np.ndarray, tiles_info: List[dict], indices: List[int], overlap: int = 0
) -> np.ndarray:
    """Stack the tiles in `indices` (all of one shape) into one batch at their
    exact size: [len(indices), T, h+2o, w+2o, C].  Only halo context is
    edge-replicate padded."""
    t, H, W, c = frames.shape
    th = tiles_info[indices[0]]["height"]
    tw = tiles_info[indices[0]]["width"]
    out = np.empty((len(indices), t, th + 2 * overlap, tw + 2 * overlap, c), frames.dtype)
    for j, i in enumerate(indices):
        info = tiles_info[i]
        x0 = info["x"] - overlap
        y0 = info["y"] - overlap
        x1 = info["x"] + tw + overlap
        y1 = info["y"] + th + overlap
        sx0, sy0 = max(0, x0), max(0, y0)
        sx1, sy1 = min(W, x1), min(H, y1)
        crop = frames[:, sy0:sy1, sx0:sx1]
        pad = ((0, 0), (sy0 - y0, y1 - sy1), (sx0 - x0, x1 - sx1), (0, 0))
        out[j] = np.pad(crop, pad, mode="edge")
    return out


def paste_tile_flows(
    tile_flows,
    tiles_info: List[dict],
    width: int,
    height: int,
    tile_size: int,
    overlap: int = 0,
) -> np.ndarray:
    """Assemble per-tile flows into a full [H, W, 2] canvas.  overlap == 0 is
    the reference's hard paste (videoflow_processor.py:277); overlap > 0
    blends halos with a linear feather."""
    if overlap == 0:
        full = np.zeros((height, width, 2), dtype=np.float32)
        for flow, info in zip(tile_flows, tiles_info):
            x, y, w, h = info["x"], info["y"], info["width"], info["height"]
            full[y : y + h, x : x + w] = flow[:h, :w]
        return full

    acc = np.zeros((height, width, 2), dtype=np.float32)
    wacc = np.zeros((height, width, 1), dtype=np.float32)

    def feather_for(fh, fw):
        def ramp(n):
            r = np.minimum(np.arange(n) + 1, np.arange(n)[::-1] + 1).astype(np.float32)
            return np.minimum(r, overlap + 1) / (overlap + 1)

        return ramp(fh)[:, None] * ramp(fw)[None, :]

    feathers: dict = {}
    for flow, info in zip(tile_flows, tiles_info):
        x0 = info["x"] - overlap
        y0 = info["y"] - overlap
        sx0, sy0 = max(0, x0), max(0, y0)
        sx1 = min(width, info["x"] + info["width"] + overlap)
        sy1 = min(height, info["y"] + info["height"] + overlap)
        fy0, fx0 = sy0 - y0, sx0 - x0
        fy1, fx1 = fy0 + (sy1 - sy0), fx0 + (sx1 - sx0)
        key = (flow.shape[0], flow.shape[1])
        if key not in feathers:
            feathers[key] = feather_for(*key)
        wpatch = feathers[key][fy0:fy1, fx0:fx1, None]
        acc[sy0:sy1, sx0:sx1] += flow[fy0:fy1, fx0:fx1] * wpatch
        wacc[sy0:sy1, sx0:sx1] += wpatch

    return acc / np.maximum(wacc, 1e-6)


def extract_tile_batch(frames: np.ndarray, tiles_info: List[dict], tile_size: int, overlap: int = 0) -> np.ndarray:
    """Every tile of one window [T, H, W, C] stacked to [num_tiles, T,
    tile_size + 2 overlap, tile_size + 2 overlap, C], edge-replicated where
    an edge tile or its halo leaves the frame."""
    t, h, w, c = frames.shape
    size = tile_size + 2 * overlap
    out = np.empty((len(tiles_info), t, size, size, c), dtype=frames.dtype)
    for i, info in enumerate(tiles_info):
        x0, y0 = info["x"] - overlap, info["y"] - overlap
        x1, y1 = info["x"] + tile_size + overlap, info["y"] + tile_size + overlap
        sx0, sy0, sx1, sy1 = max(0, x0), max(0, y0), min(w, x1), min(h, y1)
        pad = ((0, 0), (sy0 - y0, y1 - sy1), (sx0 - x0, x1 - sx1), (0, 0))
        out[i] = np.pad(frames[:, sy0:sy1, sx0:sx1], pad, mode="edge")
    return out
