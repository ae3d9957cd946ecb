"""Pad-to-multiple-of-8 (the reference's InputPadder contract, as
tpuflow/core/padding.py and the engine's edge padding use it)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_dims(ht: int, wd: int, multiple: int = 8, mode: str = "sintel") -> Tuple[int, int, int, int]:
    """(pad_top, pad_bottom, pad_left, pad_right).  'sintel' splits height
    padding evenly; other modes put it all on top (RAFT InputPadder)."""
    pad_ht = (((ht // multiple) + 1) * multiple - ht) % multiple
    pad_wd = (((wd // multiple) + 1) * multiple - wd) % multiple
    if mode == "sintel":
        return pad_ht // 2, pad_ht - pad_ht // 2, pad_wd // 2, pad_wd - pad_wd // 2
    return pad_ht, 0, pad_wd // 2, pad_wd - pad_wd // 2


def pad_frames_edge(frames: torch.Tensor, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """Edge-replicate padding of [M, H, W, C] frames by (top, bottom, left,
    right) — the engine's `jnp.pad(..., mode='edge')` (engine.py:533-537)."""
    pt, pb, pl, pr = pads
    if not (pt or pb or pl or pr):
        return frames
    x = F.pad(frames.permute(0, 3, 1, 2), (pl, pr, pt, pb), mode="replicate")
    return x.permute(0, 2, 3, 1)
