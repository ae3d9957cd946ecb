"""Flow-correction engine: batched phase correlation + NCC template match
(the JAX package's tools/correction.py on torch).

The reference corrects bad flow pixels one at a time in Python with
cv2.phaseCorrelate and cv2.matchTemplate inside a thread pool
(correction_worker.py:62-138, 221-342; flow_visualizer.py:2725-2865).
Here every bad pixel of a frame is corrected in two batched device passes:

  1. `ops.quality_frame` marks bad pixels (red channel > 0 — the worker
     predicate at correction_worker.py:248).
  2. coarse: extract regions around each bad pixel and its LOD-predicted
     target, batched FFT phase correlation (torch.fft) -> translation per
     pixel (correction_worker.py:80-97).
  3. fine (where coarse quality < threshold): batched NCC template match
     (TM_CCOEFF_NORMED semantics, a grouped F.conv2d with one group per
     pixel) of an 11px-radius template over a 50px-radius search area
     (correction_worker.py:99-138), plus the spiral color-match rescue
     evaluated as a single prioritized argmax over the spiral positions
     instead of a sequential walk.
  4. accept a correction if it reaches good quality or improves on the
     original (correction_worker.py:306-312); corrected flows are written
     to a sibling `<cache>_corrected/` directory (:322-330).

Every batched function computes on the device of its inputs (a numpy array
is taken as a CPU tensor); `correct_frame` and `correct_cache_range` take
numpy frames and flows and a `device` ('auto' = the card, or 'cpu'), and
keep the JAX version's host steps in numpy: the bad-pixel list, the cap at
`max_pixels`, the LOD vectors and the rounded baseline targets.

Both passes run in chunks of at most CHUNK_PAIRS pixels: every pixel is
independent, so this is the same function, and a chunk bounds the passes'
memory (the fine pass holds about 0.7 MB per pixel at the default radii).
The NCC convolutions run in full f32 whatever the process's TF32 setting
(`_f32_convolutions`); the FFTs and their products are f32 already.

Coordinate convention throughout: target = source - flow (backward
sampling), matching the correction engine.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..pipeline import ops
from ..pipeline.cache import FlowFileHandler
from ..runtime.device import DeviceManager

# Reference constants (flow_visualizer.py config; correction_worker usage).
GOOD_QUALITY_THRESHOLD = 0.98
FINE_CORRECTION_THRESHOLD = 0.95
DETAIL_ANALYSIS_REGION_SIZE = 50
TEMPLATE_RADIUS = 11
SEARCH_RADIUS = 50
# Pixels per device pass of the coarse and the fine batch.
CHUNK_PAIRS = 16384


def generate_spiral_offsets(width: int, height: int) -> np.ndarray:
    """Outward spiral coordinates from the center, in visit order
    (correction_worker.py:33-42)."""
    out = []
    x, y = 0, 0
    dx, dy = 0, -1
    for _ in range(max(width, height) ** 2):
        if (-width / 2 < x <= width / 2) and (-height / 2 < y <= height / 2):
            out.append((x, y))
        if x == y or (x < 0 and x == -y) or (x > 0 and x == 1 - y):
            dx, dy = -dy, dx
        x, y = x + dx, y + dy
    return np.asarray(out, dtype=np.int32)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """x.astype(int32) as XLA converts a float (NaN to 0, saturate at the
    int32 range, truncate), as an int64 tensor; integers pass through."""
    if not x.is_floating_point():
        return x.long()
    x = torch.nan_to_num(x.float(), nan=0.0).clamp(-(2.0**31), 2.0**31)
    return x.long().clamp(-(2**31), 2**31 - 1)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """An int64 result of int32 arithmetic wrapped as int32 wraps, so that a
    saturated target (an infinite flow) lands where the JAX version's does."""
    return (x + 2**31) % 2**32 - 2**31


@contextlib.contextmanager
def _f32_convolutions():
    """cuDNN convolutions in full f32 inside the block, whatever the
    process's `torch.backends.cudnn.allow_tf32` (True by default): NCC's
    `ssq - ssum**2 / area` of 0-255 pixels cancels to noise at TF32's
    10-bit mantissa.  The caller's setting is restored."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _chunked(fn: Callable[..., Dict[str, torch.Tensor]], per_pair: Tuple[torch.Tensor, ...]):
    """fn over per-pixel tensors in chunks of CHUNK_PAIRS rows, its dict
    results concatenated."""
    n = per_pair[0].shape[0]
    if n <= CHUNK_PAIRS:
        return fn(*per_pair)
    parts = [fn(*(x[i : i + CHUNK_PAIRS] for x in per_pair)) for i in range(0, n, CHUNK_PAIRS)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------------------
# Batched region extraction
# ---------------------------------------------------------------------------
def extract_regions(image, centers_x, centers_y, radius: int) -> torch.Tensor:
    """Extract [N, 2r, 2r(, C)] square regions with zero padding outside
    the image (correction_worker.py:44-60 semantics: the region starts at
    center - radius clamped to 0 and is zero-padded at the bottom/right to
    2r).  Batched gather."""
    image = ops._tensor(image)
    dev = image.device
    h, w = image.shape[0], image.shape[1]
    size = int(2 * radius)
    cx = _int32(ops._tensor(centers_x).to(dev))
    cy = _int32(ops._tensor(centers_y).to(dev))
    x1 = _wrap(cx - radius).clamp(min=0)
    y1 = _wrap(cy - radius).clamp(min=0)
    x2 = _wrap(cx + radius).clamp(max=w)
    y2 = _wrap(cy + radius).clamp(max=h)

    d = torch.arange(size, device=dev)
    xs = _wrap(x1[:, None] + d[None, :])      # [N, size]
    ys = _wrap(y1[:, None] + d[None, :])
    valid = (xs < x2[:, None])[:, None, :] & (ys < y2[:, None])[:, :, None]

    flat = ys.clamp(0, h - 1)[:, :, None] * w + xs.clamp(0, w - 1)[:, None, :]
    gathered = image.reshape(h * w, *image.shape[2:])[flat]  # [N, size, size(, C)]
    if gathered.ndim == 4:
        valid = valid[..., None]
    return torch.where(valid, gathered, torch.zeros((), dtype=gathered.dtype, device=dev))


def to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY weights."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).float()


# ---------------------------------------------------------------------------
# Batched phase correlation
# ---------------------------------------------------------------------------
def phase_correlate_batch(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation estimate per pair via the cross-power spectrum
    (cv2.phaseCorrelate semantics, correction_worker.py:62-78): peak of
    the inverse FFT of the normalized cross spectrum, refined to subpixel
    with a 5x5 weighted centroid around the peak, and a confidence equal
    to the response at the peak.

    a, b: [N, H, W] float32 grayscale. Returns (shift_xy [N, 2], conf [N])
    where b ~= a shifted by shift_xy."""
    n, h, w = a.shape
    dev = a.device
    fa = torch.fft.rfft2(a)
    fb = torch.fft.rfft2(b)
    cross = torch.conj(fa) * fb
    cross = cross / torch.clamp(cross.abs(), min=1e-10)
    resp = torch.fft.irfft2(cross, s=(h, w))  # [N, H, W]

    flat_idx = resp.reshape(n, -1).argmax(dim=-1)     # the first maximum
    py = flat_idx // w
    px = flat_idx % w

    # 5x5 weighted centroid around the (wrapped) peak.
    off = torch.arange(-2, 3, device=dev)
    dy, dx = off[:, None].expand(5, 5), off[None, :].expand(5, 5)
    ys = (py[:, None, None] + dy[None]) % h
    xs = (px[:, None, None] + dx[None]) % w
    rows = torch.arange(n, device=dev)
    vals = resp[rows[:, None, None], ys, xs].clamp(min=0.0)
    wsum = vals.sum(dim=(1, 2)).clamp(min=1e-10)
    # Centroid in wrapped offsets relative to the peak.
    cy = (vals * dy[None].float()).sum(dim=(1, 2)) / wsum
    cx = (vals * dx[None].float()).sum(dim=(1, 2)) / wsum

    # Unwrap: peaks beyond the Nyquist fold are negative shifts.
    sx = torch.where(px > w // 2, px - w, px).float() + cx
    sy = torch.where(py > h // 2, py - h, py).float() + cy

    conf = resp[rows, py, px].clamp(0.0, 1.0)
    return torch.stack([sx, sy], dim=-1), conf


# ---------------------------------------------------------------------------
# Batched NCC template matching (TM_CCOEFF_NORMED)
# ---------------------------------------------------------------------------
def ncc_match_batch(search: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """TM_CCOEFF_NORMED response maps for N independent (search, template)
    pairs — the batched analogue of cv2.matchTemplate at
    correction_worker.py:107.

    search:   [N, S, S, C] float32
    template: [N, t, t, C] float32
    Returns [N, S-t+1, S-t+1] responses in [-1, 1]."""
    n, s, _, c = search.shape
    t = template.shape[1]
    area = t * t * c

    tmean = template.mean(dim=(1, 2, 3), keepdim=True)
    tz = template - tmean
    tnorm = torch.sqrt((tz**2).sum(dim=(1, 2, 3)))  # [N]

    # One group per pair: the batch folded into channels, [1, N*C, S, S]
    # against [N, C, t, t].
    lhs = search.permute(0, 3, 1, 2).reshape(1, n * c, s, s)
    ones = torch.ones((n, c, t, t), dtype=search.dtype, device=search.device)
    with _f32_convolutions():
        num = F.conv2d(lhs, tz.permute(0, 3, 1, 2).contiguous(), groups=n)[0]  # [N, out, out]
        # Window sums for the search mean/std: a ones kernel per group.
        ssum = F.conv2d(lhs, ones, groups=n)[0]
        del lhs
        sq = (search**2).permute(0, 3, 1, 2).reshape(1, n * c, s, s)
        ssq = F.conv2d(sq, ones, groups=n)[0]
        del sq

    svar = torch.clamp(ssq - ops._div(ssum**2, float(area)), min=0.0)
    snorm = torch.sqrt(svar)

    denom = snorm * tnorm[:, None, None]
    return torch.where(denom > 1e-6, num / torch.clamp(denom, min=1e-30), torch.zeros_like(num))


# ---------------------------------------------------------------------------
# The correction passes
# ---------------------------------------------------------------------------
def _pair_args(frame1, frame2, *per_pair):
    """Frames as tensors, and the per-pixel arguments on their device."""
    frame1, frame2 = ops._tensor(frame1), ops._tensor(frame2)
    return (frame1, frame2) + tuple(ops._tensor(x).to(frame1.device) for x in per_pair)


def coarse_correction_batch(
    frame1,
    frame2,
    sources,       # [N, 2] (x, y) int
    lod_flows,     # [N, 2] LOD-predicted flow at each source
    region_size: int = DETAIL_ANALYSIS_REGION_SIZE,
) -> Dict[str, torch.Tensor]:
    """Batched coarse correction (correction_worker.py:80-97): phase-
    correlate the region around each source with the region around its
    LOD-predicted target; corrected_flow = lod_flow - shift.

    Returns dict of per-pixel tensors: flow [N,2], target [N,2],
    similarity [N], confidence [N]."""
    frame1, frame2, sources, lod_flows = _pair_args(frame1, frame2, sources, lod_flows)
    h, w = frame1.shape[0], frame1.shape[1]
    g1 = to_gray(frame1.float())
    g2 = to_gray(frame2.float())

    def run(src, lod):
        lod = lod.float()
        sx = src[:, 0].float()
        sy = src[:, 1].float()
        lod_tx = sx - lod[:, 0]
        lod_ty = sy - lod[:, 1]
        r1 = extract_regions(g1, src[:, 0], src[:, 1], region_size)
        r2 = extract_regions(g2, _int32(lod_tx), _int32(lod_ty), region_size)
        shift, conf = phase_correlate_batch(r1, r2)
        corrected = lod - shift  # [N, 2]

        tgt_x = sx - corrected[:, 0]
        tgt_y = sy - corrected[:, 1]
        inb = (tgt_x >= 0) & (tgt_x < w) & (tgt_y >= 0) & (tgt_y < h)
        txi = ops._index(tgt_x, w)
        tyi = ops._index(tgt_y, h)
        src_colors = frame1[src[:, 1].long(), src[:, 0].long()].float()
        tgt_colors = frame2[tyi, txi].float()
        q = ops.pixel_quality(src_colors, tgt_colors)
        return {
            "flow": corrected,
            "target": torch.stack([tgt_x, tgt_y], dim=-1),
            "similarity": torch.where(inb, q, torch.zeros_like(q)),
            "confidence": conf,
        }

    return _chunked(run, (sources, lod_flows))


def fine_correction_batch(
    frame1,
    frame2,
    sources,         # [N, 2]
    coarse_targets,  # [N, 2] float
    template_radius: int = TEMPLATE_RADIUS,
    search_radius: int = SEARCH_RADIUS,
    threshold: float = GOOD_QUALITY_THRESHOLD,
) -> Dict[str, torch.Tensor]:
    """Batched fine correction (correction_worker.py:99-138): NCC template
    match + spiral color rescue.

    The spiral rescue evaluates all spiral positions at once and picks the
    FIRST good one in spiral order (prioritized argmax), matching the
    reference's sequential early-exit walk."""
    frame1, frame2, sources, coarse_targets = _pair_args(frame1, frame2, sources, coarse_targets)
    dev = frame1.device
    h, w = frame1.shape[0], frame1.shape[1]
    f1 = frame1.float()
    f2 = frame2.float()
    spiral = torch.as_tensor(generate_spiral_offsets(template_radius * 2, template_radius * 2),
                             device=dev).long()
    k = spiral.shape[0]
    # First good spiral position: argmax of the good flag weighted by
    # reverse order, so that earlier positions win.
    rank = (k - torch.arange(k, device=dev)).float()[None, :]

    def run(src, ct):
        n = src.shape[0]
        rows = torch.arange(n, device=dev)
        sxi, syi = src[:, 0].long(), src[:, 1].long()
        template = extract_regions(f1, sxi, syi, template_radius)
        ctx = _int32(ct[:, 0])
        cty = _int32(ct[:, 1])
        search = extract_regions(f2, ctx, cty, search_radius)

        resp = ncc_match_batch(search, template).reshape(n, -1)  # [N, out*out]
        del search, template
        out_dim = 2 * (search_radius - template_radius) + 1
        flat = resp.argmax(dim=-1)                              # the first maximum
        loc_y = flat // out_dim
        loc_x = flat % out_dim
        max_val = resp[rows, flat]

        # Search-area origin (clamped like extract_regions).
        sb_x = _wrap(ctx - search_radius).clamp(min=0)
        sb_y = _wrap(cty - search_radius).clamp(min=0)
        patch_cx = _wrap(_wrap(sb_x + loc_x) + template_radius)
        patch_cy = _wrap(_wrap(sb_y + loc_y) + template_radius)

        src_colors = f1[syi, sxi]
        patch_sim = ops.pixel_quality(src_colors, f2[patch_cy.clamp(0, h - 1), patch_cx.clamp(0, w - 1)])

        # Spiral rescue around the matched patch center.
        cand_x = _wrap(patch_cx[:, None] + spiral[None, :, 0])
        cand_y = _wrap(patch_cy[:, None] + spiral[None, :, 1])
        inb = (cand_x >= 0) & (cand_x < w) & (cand_y >= 0) & (cand_y < h)
        cand_sim = ops.pixel_quality(src_colors[:, None, :], f2[cand_y.clamp(0, h - 1), cand_x.clamp(0, w - 1)])
        cand_good = (cand_sim > threshold) & inb
        first = (cand_good.float() * rank).argmax(dim=-1)
        any_good = cand_good.any(dim=-1)

        use_spiral = (patch_sim <= threshold) & any_good
        fin_x = torch.where(use_spiral, cand_x[rows, first], patch_cx)
        fin_y = torch.where(use_spiral, cand_y[rows, first], patch_cy)
        fin_sim = torch.where(use_spiral, cand_sim[rows, first], patch_sim)

        return {
            "flow": torch.stack([src[:, 0].float() - fin_x, src[:, 1].float() - fin_y], dim=-1),
            "target": torch.stack([fin_x, fin_y], dim=-1).float(),
            "similarity": fin_sim,
            "confidence": max_val,
        }

    return _chunked(run, (sources, coarse_targets))


# ---------------------------------------------------------------------------
# Frame level: the batched replacement of worker_process
# ---------------------------------------------------------------------------
def _numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in d.items()}


def correct_frame(
    frame1: np.ndarray,
    frame2: np.ndarray,
    flow: np.ndarray,
    lod_flow: Optional[np.ndarray] = None,
    good_quality_threshold: float = GOOD_QUALITY_THRESHOLD,
    fine_threshold: float = FINE_CORRECTION_THRESHOLD,
    max_pixels: int = 65536,
    device="auto",
) -> Dict:
    """Correct all bad pixels of one frame in two batched device passes
    (the reference loops pixels in Python, correction_worker.py:268-312),
    on `device` ('auto' = the card; 'cpu').

    Returns {'flow': corrected flow, 'initial_errors': int,
    'final_errors': int}."""
    dev = DeviceManager.get_device(device) if isinstance(device, str) else device

    def up(x) -> torch.Tensor:
        """A copy of a host array on `dev` (cached flows are read-only)."""
        return ops._tensor(np.array(x)).to(dev)

    h, w = frame1.shape[:2]
    f1, f2 = up(frame1), up(frame2)
    qf = ops.quality_frame(f1, f2, up(flow), good_quality_threshold).cpu().numpy()
    bad_y, bad_x = np.where(qf[:, :, 0] > 0)
    initial = len(bad_y)
    if initial == 0:
        return {"flow": flow, "initial_errors": 0, "final_errors": 0}
    if initial > max_pixels:
        order = np.argsort(-qf[bad_y, bad_x, 0])[:max_pixels]
        bad_y, bad_x = bad_y[order], bad_x[order]

    sources = np.stack([bad_x, bad_y], axis=-1).astype(np.int32)

    if lod_flow is None:
        lod_flow = flow
    lh, lw = lod_flow.shape[:2]
    ly = np.clip((bad_y * lh) // h, 0, lh - 1)
    lx = np.clip((bad_x * lw) // w, 0, lw - 1)
    lod_vectors = lod_flow[ly, lx] / np.array([lw / w, lh / h])

    # Original similarity at each bad pixel (acceptance baseline,
    # correction_worker.py:283-292).
    orig_flow_vec = flow[bad_y, bad_x]
    otx = np.clip(np.round(bad_x - orig_flow_vec[:, 0]).astype(int), 0, w - 1)
    oty = np.clip(np.round(bad_y - orig_flow_vec[:, 1]).astype(int), 0, h - 1)
    inb = (
        (bad_x - orig_flow_vec[:, 0] >= 0) & (bad_x - orig_flow_vec[:, 0] < w)
        & (bad_y - orig_flow_vec[:, 1] >= 0) & (bad_y - orig_flow_vec[:, 1] < h)
    )
    orig_sim = np.where(
        inb,
        ops.pixel_quality(up(frame1[bad_y, bad_x]).float(), up(frame2[oty, otx]).float()).cpu().numpy(),
        0.0,
    )

    coarse = _numpy(coarse_correction_batch(f1, f2, up(sources), up(lod_vectors.astype(np.float32))))

    need_fine = coarse["similarity"] < fine_threshold
    final_flow_vec = coarse["flow"].copy()
    final_sim = coarse["similarity"].copy()

    if need_fine.any():
        idx = np.where(need_fine)[0]
        fine = _numpy(fine_correction_batch(f1, f2, up(sources[idx]), up(coarse["target"][idx])))
        better = fine["similarity"] > coarse["similarity"][idx]
        final_flow_vec[idx[better]] = fine["flow"][better]
        final_sim[idx[better]] = fine["similarity"][better]

    # Accept if good or improved (correction_worker.py:306-312).
    accept = (final_sim > good_quality_threshold) | (final_sim > orig_sim)
    corrected = flow.copy()
    corrected[bad_y[accept], bad_x[accept]] = final_flow_vec[accept]

    qf2 = ops.quality_frame(f1, f2, up(corrected), good_quality_threshold).cpu().numpy()
    final = int((qf2[:, :, 0] > 0).sum())
    return {"flow": corrected, "initial_errors": initial, "final_errors": final}


def correct_cache_range(
    frames: List[np.ndarray],
    flow_files: List[str],
    frame_indices: List[int],
    lod_loader=None,
    progress: bool = True,
    device="auto",
) -> List[Dict]:
    """Batch correction over a frame range, writing corrected flows to a
    sibling `<cache>_corrected/` directory (correction_worker.py:322-330).
    The reference shards this over a thread pool; the batched passes make
    one device pass per frame instead."""
    dev = DeviceManager.get_device(device) if isinstance(device, str) else device
    results = []
    iterator = frame_indices
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(frame_indices, desc="Correcting flow")
        except ImportError:
            pass
    for i in iterator:
        if i + 1 >= len(frames):
            continue
        path = Path(flow_files[i])
        flow = (
            FlowFileHandler.load_flow_flo(str(path))
            if path.suffix == ".flo"
            else FlowFileHandler.load_flow_npz(str(path))["flow"]
        )
        lod = lod_loader(i) if lod_loader else None
        res = correct_frame(frames[i], frames[i + 1], flow, lod, device=dev)
        out_dir = path.parent.with_name(path.parent.name + "_corrected")
        out_dir.mkdir(exist_ok=True)
        out_path = out_dir / path.name
        if out_path.suffix == ".flo":
            FlowFileHandler.save_flow_flo(res["flow"], str(out_path))
        else:
            FlowFileHandler.save_flow_npz(res["flow"], str(out_path))
        res["path"] = str(out_path)
        results.append(res)
    return results
