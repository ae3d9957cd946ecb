"""Convex 8x flow upsampling (RAFT §3.3) and the plain bilinear one
(tpuflow/core/update.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import strips


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow [B, h, w, 2] at 1/8 resolution, mask [B, h, w, 576] with channel
    c = k*64 + u*8 + v (9 neighbour weights k for each sub-pixel (u, v)) ->
    [B, 8h, 8w, 2], vectors scaled by 8.  In a strip (core/strips.py) the
    neighbourhood's row above and below come from the neighbouring strips."""
    b, h, w, _ = flow.shape
    weights = torch.softmax(mask.reshape(b, h, w, 9, 64), dim=3)
    strip = strips.current()
    if strip is None:
        padded = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))             # zero border
    else:
        start, stop = strip.span(h)
        padded = F.pad(8.0 * strip.fetch(flow, 1, start - 1, stop + 1), (0, 0, 1, 1))
    nbrs = torch.stack(
        [padded[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)],
        dim=3,
    )                                                              # [B, h, w, 9, 2]
    up = torch.einsum("bhwku,bhwkc->bhwuc", weights, nbrs)          # [B, h, w, 64, 2]
    up = up.reshape(b, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)      # [B, h, u, w, v, 2]
    return up.reshape(b, 8 * h, 8 * w, 2)


def upsample_flow_bilinear(flow: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Plain bilinear upsample of flow [B, h, w, 2] by `factor`, vectors
    scaled by it (tpuflow/core/update.py:63, jax.image.resize 'bilinear':
    half-pixel centres, edges clamped)."""
    x = F.interpolate(flow.permute(0, 3, 1, 2), scale_factor=factor, mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1) * factor
