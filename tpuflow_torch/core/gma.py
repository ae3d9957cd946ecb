"""GMA global motion aggregation (port of tpuflow/core/gma.py).

The context attention's q/k are computed once per window (`Attention`) and
re-applied to the motion features on every refinement iteration
(`Aggregate`), whose softmax(q k^T) v is kernel K2
(kernels/flashattn.py).  Layout: NHWC at the public functions.

State-dict names follow upstream: att.to_qk.weight,
update_block.aggregator.to_v.weight, update_block.aggregator.gamma.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.flashattn import flash_attention_fwd


def conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv applied to NHWC features as the linear map it is."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class Attention(nn.Module):
    """Content-only GMA attention (heads=1): context [B, h, w, dim] ->
    (q * dim_head^-0.5, k), each [B, h, w, dim_head]."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.scale = dim_head ** -0.5
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, fmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q, k = conv1x1(fmap, self.to_qk).chunk(2, dim=-1)
        return q * self.scale, k


class Aggregate(nn.Module):
    """out = fmap + gamma * softmax(q k^T) v,  v = to_v(fmap).  VideoFlow's
    aggregator has dim == dim_head (128), so upstream's output projection
    for dim != dim_head does not exist here."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, q: torch.Tensor, k: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = fmap.shape
        v = conv1x1(fmap, self.to_v)
        d = v.shape[-1]
        out = flash_attention_fwd(
            q.reshape(b, h * w, d).to(v.dtype).contiguous(),
            k.reshape(b, h * w, d).to(v.dtype).contiguous(),
            v.reshape(b, h * w, d).contiguous(),
        ).reshape(b, h, w, d).to(fmap.dtype)
        return fmap + self.gamma.to(fmap.dtype) * out
