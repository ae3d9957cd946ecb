"""Pad-to-multiple-of-8 (the reference's InputPadder contract, as
tpuflow/core/padding.py and the engine's edge padding use it), and the
shape buckets of tpuflow/core/padding.py."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

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


class InputPadder:
    """Pads [..., H, W] tensors to a multiple of `multiple` with replicated
    edges; `unpad` crops back (tpuflow/core/padding.py:32, the reference's
    upstream InputPadder)."""

    def __init__(self, dims: Sequence[int], multiple: int = 8, mode: str = "sintel"):
        self.ht, self.wd = int(dims[-2]), int(dims[-1])
        self.pt, self.pb, self.pl, self.pr = pad_dims(self.ht, self.wd, multiple, mode)

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return self.ht + self.pt + self.pb, self.wd + self.pl + self.pr

    def pad(self, *inputs: torch.Tensor):
        out = []
        for x in inputs:
            rows = torch.arange(-self.pt, self.ht + self.pb, device=x.device).clamp(0, self.ht - 1)
            cols = torch.arange(-self.pl, self.wd + self.pr, device=x.device).clamp(0, self.wd - 1)
            out.append(x.index_select(-2, rows).index_select(-1, cols))
        return out[0] if len(out) == 1 else out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.pt : self.pt + self.ht, self.pl : self.pl + self.wd]


def bucket_shape(ht: int, wd: int, quantum: int = 64) -> Tuple[int, int]:
    """(H, W) rounded up to multiples of `quantum` (tpuflow/core/padding.py:55)."""
    return math.ceil(ht / quantum) * quantum, math.ceil(wd / quantum) * quantum
