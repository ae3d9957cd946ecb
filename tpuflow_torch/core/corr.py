"""All-pairs correlation pyramid + radius lookup, dense subset (port of
tpuflow/core/corr.py's DenseCorrPyramid path).

Each level is one matmul of the source features against the target
features 2^l-average-pooled in f32 (the reference's F.avg_pool2d chain up
to summation order), scaled by 1/sqrt(C) and stored in the features'
dtype as a flat [N, lh, lw] volume, N = B*h*w.  The TPU package regroups
levels into a tile-aligned [N, nh, g*lw] layout for Mosaic; a GPU kernel
indexes the flat layout directly, so that layout is not ported.

The lookup is kernel K1 (kernels/denselookup.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..kernels.denselookup import dense_lookup

MATERIALIZE_THRESHOLD = 168 * 168


def pyramid_level_dims(h2: int, w2: int, level: int) -> Tuple[int, int]:
    """Spatial dims of pyramid level `level` (VALID 2x pooling)."""
    for _ in range(level):
        h2, w2 = h2 // 2, w2 // 2
    return h2, w2


def corr_feature_dim(num_levels: int, radius: int) -> int:
    return num_levels * (2 * radius + 1) ** 2


class DenseCorrPyramid:
    """Materialized pyramid: levels [B*h*w, lh, lw] in the features' dtype."""

    def __init__(self, pyramid: List[torch.Tensor]):
        self.pyramid = pyramid

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4):
        """fmap1 [B, h, w, C] source, fmap2 [B, h2, w2, C] target features."""
        b, h, w, c = fmap1.shape
        h2, w2 = fmap2.shape[1], fmap2.shape[2]
        scale = 1.0 / math.sqrt(c)
        dt = fmap1.dtype
        q = fmap1.reshape(b, h * w, c)
        f2l = fmap2.float()
        pyramid = []
        for lvl in range(num_levels):
            lh, lw = pyramid_level_dims(h2, w2, lvl)
            if lvl > 0:
                # Odd trailing row/col dropped before the 2x2 mean.
                f2l = f2l[:, : 2 * lh, : 2 * lw].reshape(b, lh, 2, lw, 2, c).mean(dim=(2, 4))
            flat = f2l.to(dt).reshape(b, lh * lw, c)
            # f32 accumulation inside the matmul; the 1/sqrt(C) scale is a
            # power of two at C=256, so the bf16 product rounds once.
            vol = torch.matmul(q, flat.transpose(1, 2)).mul_(scale)
            pyramid.append(vol.reshape(b * h * w, lh, lw))
        return cls(pyramid)

    def lookup(self, flow: torch.Tensor, radius: int = 4) -> torch.Tensor:
        """flow [B, h, w, 2] f32 -> [B, h, w, L*(2r+1)^2] f32 (zero borders,
        upstream x-major window order)."""
        return dense_lookup(self.pyramid, flow.contiguous(), radius)


def make_corr(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, impl: str = "auto"
) -> DenseCorrPyramid:
    """'auto' materializes the pyramid up to 168x168 feature grids.  Larger
    grids need FlashCorr2 (TPU kernel K3), and every other `impl` is a
    formulation of a later slice; neither is ported yet."""
    if impl != "auto":
        raise NotImplementedError(
            f"corr_impl={impl!r} is not ported yet: only 'auto' is "
            "(other formulations are later slices of the port; see ROADMAP.md)."
        )
    if fmap1.shape[1] * fmap1.shape[2] > MATERIALIZE_THRESHOLD:
        raise NotImplementedError(
            f"feature grid {fmap1.shape[1]}x{fmap1.shape[2]} exceeds the dense "
            "threshold of 168x168: it needs FlashCorr2 (TPU kernel K3, "
            "kernels/flashcorr2.py), a later slice of the port."
        )
    return DenseCorrPyramid.build(fmap1, fmap2, num_levels)
