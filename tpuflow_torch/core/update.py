"""Convex 8x flow upsampling (RAFT §3.3; tpuflow/core/update.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow [B, h, w, 2] at 1/8 resolution, mask [B, h, w, 576] with channel
    c = k*64 + u*8 + v (9 neighbour weights k for each sub-pixel (u, v)) ->
    [B, 8h, 8w, 2], vectors scaled by 8."""
    b, h, w, _ = flow.shape
    weights = torch.softmax(mask.reshape(b, h, w, 9, 64), dim=3)
    padded = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))                 # zero border
    nbrs = torch.stack(
        [padded[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)],
        dim=3,
    )                                                              # [B, h, w, 9, 2]
    up = torch.einsum("bhwku,bhwkc->bhwuc", weights, nbrs)          # [B, h, w, 64, 2]
    up = up.reshape(b, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)      # [B, h, u, w, v, 2]
    return up.reshape(b, 8 * h, 8 * w, 2)
