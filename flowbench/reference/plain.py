"""Plain geometry around the reference models, written from the reference
pipeline's description (InputPadder), independent of the program: frames
edge-padded to a multiple of 8, split evenly between the two sides (the
extra row or column at the bottom or right); MemFlow streamed over a
segment with its memory carried; and the flows' end-point gaps and outlier
share.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pad8(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[..., H, W] edge-padded to multiples of 8 -> (padded, (top, left))."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    top, left = ph // 2, pw // 2
    lead = x.shape[:-2]
    y = F.pad(x.reshape(-1, 1, h, w), (left, pw - left, top, ph - top), mode="replicate")
    return y.reshape(*lead, h + ph, w + pw), (top, left)


def to_unit(frames: np.ndarray, device) -> torch.Tensor:
    """uint8 frames [N, H, W, 3] -> float32 [N, 3, H, W] in [0, 1]."""
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device).permute(0, 3, 1, 2).float() / 255.0


@torch.no_grad()
def memflow_replay(model, frames: np.ndarray, upto: int, device) -> np.ndarray:
    """Flows [upto + 1, H, W, 2] of frames 0..upto streamed through a MemFlow
    reference model: frame j from the pair (j - 1, j) (frame 0 with itself),
    the memory carried from frame to frame, starting empty."""
    n, h, w = frames.shape[:3]
    out = np.zeros((upto + 1, h, w, 2), np.float32)
    x = to_unit(frames[: upto + 1], device)
    padded, (top, left) = pad8(x)
    memory = model.empty_memory(1, padded.shape[-2], padded.shape[-1], device)
    for j in range(upto + 1):
        pair = torch.stack([padded[max(j - 1, 0)], padded[j]])[None]
        flow, memory, _ = model(pair, memory)
        out[j] = flow[0, :, top : top + h, left : left + w].permute(1, 2, 0).cpu().numpy()
    return out


def flow_outlier_pct(got: np.ndarray, ref: np.ndarray, px: float = 3.0, share: float = 0.05) -> float:
    """The share of pixels, in percent, whose end-point distance from `ref`
    exceeds both `px` pixels and `share` of the reference's own length:
    KITTI 2015's Fl (Menze and Geiger, CVPR 2015), which judges slow and
    fast motion alike."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    epe = np.sqrt(((got - ref) ** 2).sum(-1))
    length = np.sqrt((ref**2).sum(-1))
    return float(100.0 * np.mean((epe > px) & (epe > share * length)))


def flow_gaps(got: np.ndarray, ref: np.ndarray) -> Tuple[float, float, float]:
    """(mean, largest) end-point distance of `got` [H, W, 2] from `ref` in
    pixels, and the mean end-point length of `ref`."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    epe = np.sqrt(((got - ref) ** 2).sum(-1))
    return float(epe.mean()), float(epe.max()), float(np.sqrt((ref**2).sum(-1)).mean())
