"""The one generator of the benchmark's video: every traffic mix is a file of
parameters under traffic/ that this reads.

A segment of `segment_frames` frames of `width` x `height` is drawn from the
seed and the segment's number, on the device:
- a background of low-pass random texture (noise on a grid of
  `texture_cell_px`, upsampled bicubically, plus a finer octave at a
  quarter of the cell with `detail` of its contrast), panned by one
  velocity per segment, uniform in the disc of radius `pan_max_px` px per
  frame (positions rounded to whole pixels);
- `sprites` discs of their own texture, each `sprite_min_px` to
  `sprite_max_px` across, moving at their own velocities, uniform in the
  disc of radius `sprite_speed_max_px` px per frame, wrapping around the
  frame, pasted in order over the background (motion boundaries).
Content a video codec compresses, with motion boundaries; the same seed
gives the same frames."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .weights import generator


def _texture(g, h: int, w: int, cell: int, detail: float, device) -> torch.Tensor:
    """[3, h, w] low-pass texture in [0, 1]."""
    def octave(c):
        gh, gw = math.ceil(h / c) + 3, math.ceil(w / c) + 3
        noise = torch.rand(1, 3, gh, gw, generator=g, device=device)
        up = F.interpolate(noise, size=(gh * c, gw * c), mode="bicubic", align_corners=False)
        return up[0, :, c : c + h, c : c + w]

    tex = octave(cell) + detail * (octave(max(1, cell // 4)) - 0.5)
    lo, hi = tex.amin(dim=(1, 2), keepdim=True), tex.amax(dim=(1, 2), keepdim=True)
    return (tex - lo) / (hi - lo).clamp(min=1e-6)


def _velocity(g, vmax: float, device):
    r, a = torch.rand(2, generator=g, device=device).tolist()
    r = vmax * math.sqrt(r)
    return r * math.cos(2 * math.pi * a), r * math.sin(2 * math.pi * a)


@torch.no_grad()
def segment(params: dict, seed: int, index: int, device) -> np.ndarray:
    """Segment `index` of the traffic mix `params`: uint8 [F, H, W, 3]."""
    n, h, w = params["segment_frames"], params["height"], params["width"]
    g = generator(seed, device, 1000 + index)
    margin = math.ceil(params["pan_max_px"] * n) + 1
    bg = _texture(g, h + 2 * margin, w + 2 * margin, params["texture_cell_px"], params["detail"], device)
    vx, vy = _velocity(g, params["pan_max_px"], device)
    sprites = []
    for _ in range(params["sprites"]):
        lo, hi = params["sprite_min_px"], params["sprite_max_px"]
        size = lo + int(torch.randint(0, hi - lo + 1, (1,), generator=g, device=device))
        tex = _texture(g, size, size, max(4, params["texture_cell_px"] // 2), params["detail"], device)
        yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device), indexing="ij")
        mask = ((yy - (size - 1) / 2) ** 2 + (xx - (size - 1) / 2) ** 2) <= (size / 2) ** 2
        px, py = (torch.rand(2, generator=g, device=device) * torch.tensor([w, h], device=device)).tolist()
        sprites.append((size, tex, mask, px, py, _velocity(g, params["sprite_speed_max_px"], device)))
    frames = torch.empty((n, 3, h, w), device=device)
    for i in range(n):
        oy, ox = margin + round(i * vy), margin + round(i * vx)
        frame = bg[:, oy : oy + h, ox : ox + w].clone()
        for size, tex, mask, px, py, (sx, sy) in sprites:
            x0 = int(round(px + i * sx)) % (w + size) - size
            y0 = int(round(py + i * sy)) % (h + size) - size
            fx0, fy0, fx1, fy1 = max(0, x0), max(0, y0), min(w, x0 + size), min(h, y0 + size)
            if fx1 <= fx0 or fy1 <= fy0:
                continue
            m = mask[fy0 - y0 : fy1 - y0, fx0 - x0 : fx1 - x0]
            region = frame[:, fy0:fy1, fx0:fx1]
            region[:, m] = tex[:, fy0 - y0 : fy1 - y0, fx0 - x0 : fx1 - x0][:, m]
        frames[i] = frame
    return (frames * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
