"""K6: exact-value patch from a plane-row-outer volume (port of
`band_patch_level`, tpuflow/kernels/bandlookup.py:184).

For one level stored [B, lh, Nq, lw] (BandCorrPyramid's layout: plane row
outermost, then query, then column) and clamped indices rr, cc [B, Nq,
side]: patch[b,q,i,j] = vol[b, rr[b,q,i], q, cc[b,q,j]] in the volume's
dtype.  `band_patch_level` launches csrc/volume_patch.cu (the kernel of
K4, given this layout's strides) for CUDA tensors and runs
`band_patch_level_plain` for CPU tensors; the two agree bit for bit.

The TPU kernel pads rows and lanes and reads only the row chunks a block of
queries touches, for its DMA loop; a GPU thread reads its own entry, so the
layout is stored unpadded and no ranges are computed.
"""

from __future__ import annotations

import torch

from .denselookup import _DTYPE_CODES, check_patch_indices, launch_volume_patch


def band_patch_level_plain(vol: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one gather per batch item over its flattened
    [lh*Nq*lw] volume."""
    b, lh, nq, lw = vol.shape
    side = rr.shape[2]
    q = torch.arange(nq, device=vol.device)[None, :, None, None]
    idx = (rr.long()[:, :, :, None] * nq + q) * lw + cc.long()[:, :, None, :]
    patch = torch.gather(vol.reshape(b, lh * nq * lw), 1, idx.reshape(b, nq * side * side))
    return patch.reshape(b, nq, side, side)


def band_patch_level(vol: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """vol [B, lh, Nq, lw] (bf16 or f32) + clamped rr, cc [B, Nq, side] int32
    -> patch [B, Nq, side, side] of exact volume entries.  CPU tensors: the
    plain version; CUDA tensors: the kernel."""
    check_patch_indices(rr, cc, vol.device)
    if vol.dim() != 4 or (vol.shape[0], vol.shape[2]) != tuple(rr.shape[:2]):
        raise ValueError(
            f"vol {tuple(vol.shape)}: expected [{rr.shape[0]}, lh, {rr.shape[1]}, lw]"
        )
    if vol.dtype not in _DTYPE_CODES or not vol.is_contiguous():
        raise ValueError(f"vol must be contiguous bfloat16 or float32, got {vol.dtype}")
    if vol.device.type == "cpu":
        return band_patch_level_plain(vol, rr, cc)
    if vol.device.type != "cuda":
        raise ValueError(f"band_patch_level runs on cpu or cuda, not {vol.device}")
    _, lh, nq, lw = vol.shape
    out = launch_volume_patch(
        vol, rr, cc, lh, lw, (lh * nq * lw, lw, nq * lw, 1), "band_patch_level"
    )
    band_patch_level.launches += 1
    return out


band_patch_level.launches = 0
