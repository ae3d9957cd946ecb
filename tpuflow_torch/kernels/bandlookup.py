"""K6: exact-value patch from a plane-row-outer volume (port of
`band_patch_level`, tpuflow/kernels/bandlookup.py:184).

For a level stored [B, lh, Nq, lw] (BandCorrPyramid's layout: plane row
outermost, then query, then column) and clamped indices rr, cc [B, Nq,
side]: patch[b,q,i,j] = vol[b, rr[b,q,i], q, cc[b,q,j]] in the volume's
dtype.  `band_patch_levels` takes every level of a lookup and launches
csrc/volume_patch.cu (the kernel of K4, given this layout's strides) once
for CUDA tensors, or runs `band_patch_levels_plain` for CPU tensors;
`band_patch_level` is its one-level form.  Kernel and plain version agree
bit for bit.

The TPU kernel pads rows and lanes and reads only the row chunks a block of
queries touches, for its DMA loop; a GPU warp reads its own rows, so the
layout is stored unpadded and no ranges are computed.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ._build import count_launch
from ._nograd import refuses_gradient
from .denselookup import check_volume_levels, launch_volume_patch


def band_patch_level_plain(vol: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one gather per batch item over its flattened
    [lh*Nq*lw] volume."""
    b, lh, nq, lw = vol.shape
    side = rr.shape[2]
    q = torch.arange(nq, device=vol.device)[None, :, None, None]
    idx = (rr.long()[:, :, :, None] * nq + q) * lw + cc.long()[:, :, None, :]
    patch = torch.gather(vol.reshape(b, lh * nq * lw), 1, idx.reshape(b, nq * side * side))
    return patch.reshape(b, nq, side, side)


def band_patch_levels_plain(vols: Sequence[torch.Tensor], rrs: Sequence[torch.Tensor],
                            ccs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain PyTorch version of band_patch_levels: level by level."""
    return [band_patch_level_plain(v, rr, cc) for v, rr, cc in zip(vols, rrs, ccs)]


@refuses_gradient
def band_patch_levels(vols: Sequence[torch.Tensor], rrs: Sequence[torch.Tensor],
                      ccs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every level of one lookup: vols [B, lh, Nq, lw] (bf16 or f32) + per
    level clamped rr, cc [B, Nq, side] int32 -> per level a patch
    [B, Nq, side, side] of exact volume entries.  CPU tensors: the plain
    version; CUDA tensors: the kernel, one launch for all levels (counted as
    kernels.band_patch_level.launches)."""
    check_volume_levels(vols, rrs, ccs, "band")
    dev = vols[0].device
    if dev.type == "cpu":
        return band_patch_levels_plain(vols, rrs, ccs)
    if dev.type != "cuda":
        raise ValueError(f"band_patch_level runs on cpu or cuda, not {dev}")
    outs = launch_volume_patch(vols, rrs, ccs, "band", "band_patch_level")
    count_launch(band_patch_level)
    return outs


def band_patch_level(vol: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """One level: vol [B, lh, Nq, lw] (bf16 or f32) + clamped rr, cc
    [B, Nq, side] int32 -> patch [B, Nq, side, side] of exact volume
    entries, through band_patch_levels."""
    return band_patch_levels([vol], [rr], [cc])[0]
