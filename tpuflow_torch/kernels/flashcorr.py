"""K5: recomputed correlation patch, first formulation (port of
`flash_patch_level`, tpuflow/kernels/flashcorr.py:157).

It computes what K3 computes (kernels/flashcorr2.py): for f1 [B, Nq, C], one
level of pooled target features f2l [B, lh, lw, C] and clamped rr, cc
[B, Nq, side], patch[b,q,i,j] = cast((f1[b,q] . f2l[b, rr[b,q,i],
cc[b,q,j]]) / sqrt(C)), f32 sum, one rounding to f1's dtype.  The two TPU
kernels differ only in how they store the target rows for Mosaic (K5 pads
each plane row to 128 lanes, `pad_f2_level`); unpadded, they are one CUDA
kernel, csrc/corr_patch.cu.  `flash_patch_level` launches it for CUDA
tensors and runs `flash_patch_level_plain` for CPU tensors; it serves
FlashCorr (corr_impl='flash') and counts its own launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flashcorr2 import corr_patch, flash2_patch_level_plain


# Plain PyTorch version: the same function as K3's, so the same code.
flash_patch_level_plain = flash2_patch_level_plain


def flash_patch_level(
    f1: torch.Tensor, f2l: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
    *, grid_w: Optional[int] = None,
) -> torch.Tensor:
    """f1 [B, Nq, C], f2l [B, lh, lw, C] (one dtype, bf16 or f32), clamped rr,
    cc [B, Nq, side] int32 -> patch [B, Nq, side, side] in f1's dtype.  The
    queries form a grid of width grid_w (must divide Nq; None: one row).
    CPU tensors: the plain version; CUDA tensors: the kernel."""
    return corr_patch(flash_patch_level, flash_patch_level_plain, f1, f2l, rr, cc, grid_w)


flash_patch_level.launches = 0
