"""Image and flow ops on the device: encoders, TAA, quality maps, turbulence,
LOD pyramids (the JAX package's pipeline/ops.py in PyTorch).

Plain functions on tensors, computed on the tensors' device (a numpy array
is taken as a CPU tensor, float64 as float32, as jnp.asarray does).
Numerics follow the JAX functions, and through them the reference's
numpy/cv2 formulas:

- HSV encoder          -> the reference's encoding/flow_encoders.py:30-67
- gamedev RG encoder   -> flow_encoders.py:70-117
- motion-vectors RG8   -> flow_encoders.py:120-177 (encode + exact decode)
- motion-vectors RGB8  -> flow_encoders.py:180-364 ('rgb+' by default, plus
  the legacy dir+mag and YCbCr variants)
- color wheel          -> flow_encoders.py:367-427 (torchvision's
  flow_to_image)
- TAA warp+blend       -> effects/taa_processor.py:92-262
- quality map          -> correction_worker.py:9-27, 175-208
- turbulence map       -> flow_visualizer.py:2997-3052
- LOD pyramid          -> storage/cache_manager.py:73-161

Every conversion of float to uint8 goes through `to_uint8`, which is XLA's
conversion (NaN to 0, saturate at 0 and 255, truncate) on every device:
torch's own cast wraps on the CPU and is undefined on CUDA.  Float to index
conversions likewise map NaN to 0 and clamp before the cast.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; an array-like as a CPU tensor, float64 as float32."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x))
    return t.float() if t.dtype == torch.float64 else t


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> uint8 conversion: NaN to 0, clamp to [0, 255], then
    truncate toward zero."""
    return torch.nan_to_num(x, nan=0.0).clamp(0, 255).to(torch.uint8)


def _index(x: torch.Tensor, n: int) -> torch.Tensor:
    """clip(x.astype(int32), 0, n - 1) as XLA computes it (NaN converts to
    0, and the conversion saturates), as an int64 index."""
    return torch.nan_to_num(x, nan=0.0).clamp(0, n - 1).to(torch.int64)


_TINY = torch.finfo(torch.float32).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """A non-negative tensor with its subnormal values set to 0, as XLA
    computes on the CPU and the TPU (flush to zero)."""
    return torch.where(x < _TINY, torch.zeros_like(x), x)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, as the CPU (and XLA) computes it: CUDA divides a
    tensor by a Python number as a product with its rounded reciprocal, an
    ulp off, which a later truncation to uint8 (or an exponent of -87) turns
    into a whole step.  Every division by a constant in this module goes
    through it."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _mean3(x: torch.Tensor) -> torch.Tensor:
    """The mean of the last axis of 3 as (x0 + x1 + x2) / 3, rounded alike on
    every device (a reduction kernel may sum in another order)."""
    return _div(x[..., 0] + x[..., 1] + x[..., 2], 3.0)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """jnp.mgrid[0:h, 0:w] as float32 (y, x)."""
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    return y, x


# =============================================================================
# HSV helpers (OpenCV uint8 semantics: H in [0,180], S,V in [0,255])
# =============================================================================
def hsv_to_rgb_u8(hsv) -> torch.Tensor:
    """HSV (uint8, OpenCV ranges) -> RGB uint8, matching cv2.COLOR_HSV2RGB.
    OpenCV maps H in [0,180] to [0,360) degrees; float math, then round
    (half to even)."""
    hsv = _tensor(hsv)
    h = hsv[..., 0].float() * 2.0
    s = _div(hsv[..., 1].float(), 255.0)
    v = hsv[..., 2].float()

    h60 = _div(h, 60.0)
    sector = torch.floor(h60).to(torch.int32) % 6
    f = h60 - torch.floor(h60)

    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(values, default):
        out = default
        for k in range(4, -1, -1):
            out = torch.where(sector == k, values[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    rgb = torch.stack([r, g, b], dim=-1)
    return to_uint8(torch.round(rgb))


# =============================================================================
# Flow encoders
# =============================================================================
def encode_hsv(flow) -> torch.Tensor:
    """HSV flow visualization (flow_encoders.py:38-67): hue=angle,
    sat=magnitude / per-frame max magnitude, val=255."""
    flow = torch.nan_to_num(_tensor(flow), nan=0.0, posinf=1.0, neginf=-1.0)
    magnitude = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    angle = torch.atan2(flow[..., 1], flow[..., 0])

    hue = to_uint8((_div(angle + np.pi, 2 * np.pi) * 180.0).clamp(0, 180))

    max_magnitude = magnitude.max()
    saturation = to_uint8(
        torch.where(
            max_magnitude > 0,
            magnitude / torch.clamp(max_magnitude, min=1e-30) * 255.0,
            torch.zeros_like(magnitude),
        )
    )
    value = torch.full_like(saturation, 255)
    return hsv_to_rgb_u8(torch.stack([hue, saturation, value], dim=-1))


def _rg_to_u8(enc: torch.Tensor) -> torch.Tensor:
    """[..., 2] in [0, 1] -> RGB uint8 with B = 0 (the RG encoders' tail)."""
    rgb = torch.cat([enc, torch.zeros_like(enc[..., :1])], dim=-1) * 255.0
    return to_uint8(torch.nan_to_num(rgb, nan=0.0, posinf=255.0, neginf=0.0))


def encode_gamedev(
    flow,
    width: int,
    height: int,
    scale_factor: float = 200.0,
    clamp_range: float = 20.0,
) -> torch.Tensor:
    """Gamedev RG encoding (flow_encoders.py:90-117): normalize by frame
    dims, x200, clamp +/-20, map to [0,1] in R (x) and G (y), B=0."""
    flow = _tensor(flow)
    fx = _div(flow[..., 0], width) * scale_factor
    fy = _div(flow[..., 1], height) * scale_factor
    enc = torch.stack([fx, fy], dim=-1).clamp(-clamp_range, clamp_range)
    enc = _div(enc + clamp_range, 2 * clamp_range).clamp(0.0, 1.0)
    return _rg_to_u8(enc)


def encode_motion_vectors_rg8(flow, clamp_range: float = 64.0) -> torch.Tensor:
    """RG8 UNORM encoding (flow_encoders.py:131-153)."""
    clamped = _tensor(flow).clamp(-clamp_range, clamp_range)
    enc = _div(clamped + clamp_range, 2 * clamp_range).clamp(0.0, 1.0)
    return _rg_to_u8(enc)


def decode_motion_vectors_rg8(encoded, clamp_range: float = 64.0) -> torch.Tensor:
    """Exact inverse of RG8 encode (flow_encoders.py:155-177)."""
    normalized = _div(_tensor(encoded).float(), 255.0)
    return normalized[..., :2] * (2 * clamp_range) - clamp_range


def encode_motion_vectors_rgb8(flow, clamp_range: float = 32.0, method: str = "rgb+") -> torch.Tensor:
    """RGB8 encoding (flow_encoders.py:191-293).  Default 'rgb+' method: RG
    hold the clamped direction, B holds the sqrt(1-x^2-y^2) length
    corrector."""
    flow = _tensor(flow)
    fx = flow[..., 0]
    fy = flow[..., 1]

    if method == "rgb+":
        dx = _div(fx, clamp_range)
        dy = _div(fy, clamp_range)
        length = torch.sqrt(dx**2 + dy**2)
        scale = torch.where(length > 1.0, 1.0 / torch.clamp(length, min=1e-30), torch.ones_like(length))
        dx = dx * scale
        dy = dy * scale
        corrector = torch.sqrt(torch.clamp(1.0 - dx**2 - dy**2, min=0.0))
        r = (dx.clamp(-1, 1) + 1) / 2
        g = (dy.clamp(-1, 1) + 1) / 2
        rgb = torch.stack([r, g, corrector], dim=-1)
    else:
        magnitude = torch.sqrt(fx**2 + fy**2)
        magnitude_clamped = magnitude.clamp(0, clamp_range)
        inv_mag = torch.where(
            magnitude > 1e-6, 1.0 / torch.clamp(magnitude, min=1e-30), torch.zeros_like(magnitude)
        )
        mag_norm = _div(magnitude_clamped, clamp_range)
        if method == "rgb-ycbcr":
            dx = (fx * inv_mag).clamp(-1, 1)
            dy = (fy * inv_mag).clamp(-1, 1)
            Y = mag_norm * (1 - 0.7) + 0.5 * 0.7
            Cb = 0.5 + dx * 0.2
            Cr = 0.5 + dy * 0.2
            R = Y + 1.402 * (Cr - 0.5)
            G = Y - 0.344136 * (Cb - 0.5) - 0.714136 * (Cr - 0.5)
            B = Y + 1.772 * (Cb - 0.5)
            rgb = torch.stack([R, G, B], dim=-1)
        else:  # legacy dir+mag: R=dir_x, G=magnitude, B=dir_y
            dx = ((fx * inv_mag).clamp(-1, 1) + 1) / 2
            dy = ((fy * inv_mag).clamp(-1, 1) + 1) / 2
            rgb = torch.stack([dx, mag_norm, dy], dim=-1)

    rgb = torch.nan_to_num(rgb * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return to_uint8(rgb)


def decode_motion_vectors_rgb8(encoded, clamp_range: float = 32.0, method: str = "rgb+") -> torch.Tensor:
    """Inverse of RGB8 encode (flow_encoders.py:295-364)."""
    normalized = _div(_tensor(encoded).float(), 255.0)

    if method == "rgb+":
        dx = normalized[..., 0] * 2 - 1
        dy = normalized[..., 1] * 2 - 1
        corrector = normalized[..., 2]
        corrected_len = torch.sqrt(dx**2 + dy**2 + corrector**2)
        magnitude = 1.0 / torch.clamp(corrected_len, min=1e-30) * clamp_range
    elif method == "rgb-ycbcr":
        R = normalized[..., 0]
        G = normalized[..., 1]
        B = normalized[..., 2]
        Y = 0.299 * R + 0.587 * G + 0.114 * B
        Cb = 0.5643 * (B - Y) + 0.5
        Cr = 0.7132 * (R - Y) + 0.5
        Y = _div(Y - 0.5 * 0.7, 1 - 0.7)
        dx = _div(-0.5 + Cb, 0.2)
        dy = _div(-0.5 + Cr, 0.2)
        magnitude = Y * clamp_range
    else:
        dx = normalized[..., 0] * 2 - 1
        magnitude = normalized[..., 1] * clamp_range
        dy = normalized[..., 2] * 2 - 1

    return torch.stack([dx * magnitude, dy * magnitude], dim=-1)


# Middlebury color wheel (RY=15, YG=6, GC=4, CB=11, BM=13, MR=6 = 55 colors),
# as used by torchvision.utils.flow_to_image (flow_encoders.py:367-427).
def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    colorwheel = np.zeros((ncols, 3))
    col = 0
    colorwheel[0:RY, 0] = 255
    colorwheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    colorwheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    colorwheel[col : col + YG, 1] = 255
    col += YG
    colorwheel[col : col + GC, 1] = 255
    colorwheel[col : col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    colorwheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(0, CB) / CB)
    colorwheel[col : col + CB, 2] = 255
    col += CB
    colorwheel[col : col + BM, 2] = 255
    colorwheel[col : col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    colorwheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(0, MR) / MR)
    colorwheel[col : col + MR, 0] = 255
    return colorwheel


_COLORWHEEL = torch.tensor(_make_colorwheel(), dtype=torch.float32)


def encode_colorwheel(flow) -> torch.Tensor:
    """Middlebury color-wheel visualization with torchvision flow_to_image
    semantics (per-frame max-norm normalization, then the classic Baker et
    al. wheel lookup), flow_encoders.py:399-427."""
    flow = _tensor(flow)
    wheel = _COLORWHEEL.to(flow.device)
    u = flow[..., 0]
    v = flow[..., 1]
    norm = torch.sqrt(u**2 + v**2)
    max_norm = norm.max()
    eps = 1e-5
    u = u / (max_norm + eps)
    v = v / (max_norm + eps)
    rad = torch.sqrt(u**2 + v**2)

    ncols = wheel.shape[0]
    a = _div(torch.atan2(-v, -u), np.pi)
    fk = (a + 1) / 2 * (ncols - 1)
    k0f = torch.floor(fk)
    # jnp's gather wraps a negative index once and clamps the rest; a NaN
    # flow gives NaN here, which converts to index 0 (its colour is NaN
    # anyway and encodes as 0).
    k0 = torch.nan_to_num(k0f, nan=0.0).clamp(-ncols, ncols - 1).to(torch.int64)
    k0 = torch.where(k0 < 0, k0 + ncols, k0)
    k1 = (k0 + 1) % ncols
    f = (fk - k0f.nan_to_num(nan=0.0))[..., None]

    col0 = _div(wheel[k0], 255.0)
    col1 = _div(wheel[k1], 255.0)
    col = (1 - f) * col0 + f * col1
    col = 1 - rad[..., None] * (1 - col)
    return to_uint8(torch.floor(255.0 * col))


def encode_flow(
    flow,
    width: int,
    height: int,
    format_name: str = "gamedev",
    clamp_range: float = 32.0,
) -> torch.Tensor:
    """Dispatch by format name (flow_encoders.py:430-499)."""
    format_name = format_name.lower()
    if format_name == "hsv":
        return encode_hsv(flow)
    if format_name == "gamedev":
        return encode_gamedev(flow, width, height)
    if format_name == "torchvision":
        return encode_colorwheel(flow)
    if format_name == "motion-vectors-rg8":
        return encode_motion_vectors_rg8(flow, clamp_range)
    if format_name == "motion-vectors-rgb8":
        return encode_motion_vectors_rgb8(flow, clamp_range)
    raise ValueError(
        f"Unsupported format '{format_name}'. Available formats: "
        "hsv, gamedev, torchvision, motion-vectors-rg8, motion-vectors-rgb8"
    )


# =============================================================================
# Bilinear / bilateral resampling + TAA
# =============================================================================
def bilinear_sample(image, x, y) -> torch.Tensor:
    """Bilinear gather at float coords (taa_processor.py:218-262).
    image: [H, W, C]; x, y: [H, W] (or any matching shape)."""
    image, x, y = _tensor(image), _tensor(x), _tensor(y)
    h, w = image.shape[0], image.shape[1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x0 = x0.clamp(0, w - 1)
    y0 = y0.clamp(0, h - 1)

    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    p00 = image[y0, x0]
    p01 = image[y0, x1]
    p10 = image[y1, x0]
    p11 = image[y1, x1]
    return (
        p00 * (1 - wx) * (1 - wy)
        + p01 * wx * (1 - wy)
        + p10 * (1 - wx) * wy
        + p11 * wx * wy
    )


def bilateral_reprojection_sample(image, x, y, current_frame, sigma_color: float = 25.0) -> torch.Tensor:
    """4-tap bilinear weights x luminance-similarity Gaussian weights
    (taa_processor.py:149-216).  The reference clamps x0 to w-2 / y0 to
    h-2 (not w-1), reproduced here.  Where the luminances differ by about
    100 levels or more the weights underflow; they are flushed to zero as
    XLA flushes them (a pixel whose four weights all flush takes no
    history), so that the result does not depend on a device's subnormal
    arithmetic.  The weights' exponent reaches -87, which turns an ulp of
    its argument into 87 ulps of the weight, so the argument is rounded
    alike on every device (_mean3, _div)."""
    image, x, y, current_frame = _tensor(image), _tensor(x), _tensor(y), _tensor(current_frame)
    h, w = image.shape[0], image.shape[1]
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 2)
    x1 = x0 + 1
    y1 = y0 + 1

    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    p00 = image[y0, x0]
    p01 = image[y0, x1]
    p10 = image[y1, x0]
    p11 = image[y1, x1]

    current_lum = _mean3(current_frame)
    sigma_sq = sigma_color**2 * 0.1

    def color_weight(p):
        lum_diff = current_lum - _mean3(p)
        return _flush(torch.exp(_div(-(lum_diff * lum_diff), 2 * sigma_sq + 1e-6)))[..., None]

    w00 = _flush((1 - wx) * (1 - wy) * color_weight(p00))
    w01 = _flush(wx * (1 - wy) * color_weight(p01))
    w10 = _flush((1 - wx) * wy * color_weight(p10))
    w11 = _flush(wx * wy * color_weight(p11))

    total = w00 + w01 + w10 + w11
    total = torch.where(total == 0, torch.full_like(total, 1e-6), total)
    num = _flush(p00 * w00) + _flush(p01 * w01) + _flush(p10 * w10) + _flush(p11 * w11)
    return num / total


def taa_step(
    current_frame,
    flow_pixels,
    previous_taa,
    alpha: float = 0.1,
    use_flow: bool = True,
    use_bilateral: bool = True,
    sigma_color: float = 25.0,
) -> torch.Tensor:
    """One TAA step: reproject the history along the flow, EMA blend
    (taa_processor.py:41-147).  current_frame: [H, W, 3] 0-255; the result
    is float32."""
    current = _tensor(current_frame).float()
    previous_taa = _tensor(previous_taa)
    if not use_flow or flow_pixels is None:
        return alpha * current + (1 - alpha) * previous_taa

    flow_pixels = _tensor(flow_pixels)
    h, w = current.shape[0], current.shape[1]
    y_coords, x_coords = _grid(h, w, current.device)
    prev_x = x_coords + flow_pixels[..., 0]
    prev_y = y_coords + flow_pixels[..., 1]
    prev_x = torch.nan_to_num(prev_x, nan=0.0, posinf=w - 1, neginf=0.0).clamp(0, w - 1)
    prev_y = torch.nan_to_num(prev_y, nan=0.0, posinf=h - 1, neginf=0.0).clamp(0, h - 1)

    if use_bilateral:
        reprojected = bilateral_reprojection_sample(previous_taa, prev_x, prev_y, current, sigma_color)
    else:
        reprojected = bilinear_sample(previous_taa, prev_x, prev_y)
    return alpha * current + (1 - alpha) * reprojected


# =============================================================================
# Quality + turbulence maps
# =============================================================================
def pixel_quality(src_pixels, dst_pixels) -> torch.Tensor:
    """Per-pixel color-match quality = mean of (RGB-distance similarity,
    abs-diff similarity, remapped cosine similarity)
    (correction_worker.py:9-27; cosine mapped (cos+1)/2, with the
    norm-difference fallback for near-black pixels)."""
    src = _tensor(src_pixels).float()
    dst = _tensor(dst_pixels).float()
    diff = src - dst
    dist = torch.sqrt((diff**2).sum(dim=-1))
    max_dist = float(np.sqrt(np.float32(3.0))) * 255.0
    sim_dist = 1.0 - _div(dist, max_dist)

    abs_diff = _mean3(diff.abs())
    sim_abs = 1.0 - _div(abs_diff, 255.0)

    dot = (src * dst).sum(dim=-1)
    norm_s = torch.sqrt((src**2).sum(dim=-1))
    norm_d = torch.sqrt((dst**2).sum(dim=-1))
    denom = norm_s * norm_d
    cos = dot / torch.clamp(denom, min=1e-30)
    sim_cos = torch.where(
        denom > 1e-12,
        (cos + 1.0) / 2.0,
        1.0 - _div((norm_s - norm_d).abs(), max_dist),
    )
    return _div(sim_dist + sim_abs + sim_cos, 3.0)


def _sample_target(frame_a, frame_b, flow, sign: float):
    """frame_b sampled at the truncated pos + sign*flow, its pixel
    quality against frame_a, and the out-of-bounds mask
    (correction_worker.py:186-191)."""
    frame_a, frame_b, flow = _tensor(frame_a), _tensor(frame_b), _tensor(flow)
    h, w = frame_a.shape[0], frame_a.shape[1]
    y_coords, x_coords = _grid(h, w, flow.device)
    tx = x_coords + sign * flow[..., 0]
    ty = y_coords + sign * flow[..., 1]
    oob = (tx < 0) | (tx >= w) | (ty < 0) | (ty >= h)
    sampled = frame_b.float()[_index(ty, h), _index(tx, w)]
    return pixel_quality(frame_a.float(), sampled), oob


def quality_map(frame_a, frame_b, flow, sign: float = -1.0) -> torch.Tensor:
    """Dense flow quality: sample frame_b at `pos + sign*flow` and compare
    colors with frame_a.  sign=-1 is the correction engine's
    `target = pos - flow` convention.  Returns [H, W] in [0,1];
    out-of-bounds targets score 0."""
    q, oob = _sample_target(frame_a, frame_b, flow, sign)
    return torch.where(oob, torch.zeros_like(q), q)


def quality_frame(frame_a, frame_b, flow, good_quality_threshold: float = 0.98) -> torch.Tensor:
    """Red/green quality visualization, the reference's GPU path
    (correction_worker.py:175-208): good pixels get green intensity
    (sim-0.5)*2, bad pixels get red 1-sim, out-of-bounds pure red."""
    sim, oob = _sample_target(frame_a, frame_b, flow, -1.0)
    green = ((sim - 0.5) * 2.0).clamp(0.0, 1.0)
    red = (1.0 - sim).clamp(0.0, 1.0)
    good = sim > good_quality_threshold
    zero = torch.zeros_like(red)
    out = torch.stack([torch.where(good, zero, red), torch.where(good, green, zero), zero], dim=-1)
    out = torch.where(oob[..., None], torch.tensor([1.0, 0.0, 0.0], device=out.device), out)
    return to_uint8(out * 255)


def _box_filter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Mean filter over edge-padded input, rows then columns (cv2.boxFilter
    with replicated borders)."""
    pad = ksize // 2
    xp = F.pad(x[None, None], (pad, pad, pad, pad), mode="replicate")
    kernel = torch.full((ksize,), 1.0 / ksize, dtype=x.dtype, device=x.device)
    xp = F.conv2d(xp, kernel.view(1, 1, 1, ksize))
    xp = F.conv2d(xp, kernel.view(1, 1, ksize, 1))
    return xp[0, 0]


def turbulence_map(flow, ksize: int = 5) -> torch.Tensor:
    """Local flow variance E[X^2]-E[X]^2 per channel, summed
    (flow_visualizer.py:2997-3052's boxFilter construction).  Returns the
    raw variance map."""
    flow = _tensor(flow)
    var = torch.zeros(flow.shape[:2], dtype=torch.float32, device=flow.device)
    for c in range(2):
        ch = flow[..., c].float()
        mean = _box_filter(ch, ksize)
        mean_sq = _box_filter(ch**2, ksize)
        var = var + torch.clamp(mean_sq - mean**2, min=0.0)
    return var


# =============================================================================
# LOD pyramid (torch twin of pipeline.cache.LODGenerator)
# =============================================================================
def lod_downsample(flow, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One weighted 2x2 downsample with bottom/right zero-padding for odd
    dims, flow scaled x0.5 (cache_manager.py:95-159)."""
    flow = _tensor(flow)
    h, w = flow.shape[0], flow.shape[1]
    pad_h, pad_w = h % 2, w % 2
    if weight is None:
        weight = torch.ones((h, w), dtype=torch.float32, device=flow.device)
    if pad_h or pad_w:
        flow = F.pad(flow, (0, 0, 0, pad_w, 0, pad_h))
        weight = F.pad(weight, (0, pad_w, 0, pad_h))

    fw = flow * weight[..., None]
    fw_sum = fw[0::2, 0::2] + fw[0::2, 1::2] + fw[1::2, 0::2] + fw[1::2, 1::2]
    w_sum = weight[0::2, 0::2] + weight[0::2, 1::2] + weight[1::2, 0::2] + weight[1::2, 1::2]
    safe = torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))
    down = torch.where((w_sum > 0)[..., None], fw_sum / safe[..., None] * 0.5, torch.zeros_like(fw_sum))
    return down.float()


def generate_lods(flow, num_lods: int = 5) -> List[torch.Tensor]:
    """Full LOD pyramid on the flow's device: a list of num_lods tensors."""
    lods = [_tensor(flow).float()]
    current = lods[0]
    for _ in range(1, num_lods):
        current = lod_downsample(current)
        lods.append(current)
    return lods


# =============================================================================
# Post-pipeline: flow -> (encoded, taa) in one step
# =============================================================================
def postprocess_step(
    flow,
    current_frame,
    previous_taa,
    width: int,
    height: int,
    flow_format: str = "gamedev",
    clamp_range: float = 32.0,
    alpha: float = 0.1,
    use_bilateral: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode the flow and apply TAA with it (the reference does these as
    separate host numpy passes, flow_processor.py:998-1109).  Callers pass
    the flow that TAA should warp along."""
    encoded = encode_flow(flow, width, height, flow_format, clamp_range)
    taa = taa_step(current_frame, flow, previous_taa, alpha=alpha, use_bilateral=use_bilateral)
    return encoded, taa
