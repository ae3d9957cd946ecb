"""All-pairs correlation + radius lookup, every formulation (port of
tpuflow/core/corr.py).

A correlation object is built from source features fmap1 [B, h, w, C] and
target features fmap2 [B, h2, w2, C]; `lookup(flow, radius)` samples, for
every source pixel and every pyramid level l, the (2r+1)^2 window of
correlations around its flow target at scale 2^l: bilinear, zero outside the
plane, channels in upstream's x-major window order, f32
[B, h, w, L*(2r+1)^2].  `make_corr` picks the formulation:

- DenseCorrPyramid ('dense', 'auto' up to 168x168 grids): levels
  materialized from 2^l-pooled target features, flat [B*h*w, lh, lw] in the
  features' dtype; lookup = kernel K1 (fused), K4 + the patch epilogue
  (`impl='patch'`), or a plain torch gather + the same epilogue
  (`impl='xla'`, the differentiable one).
- FlashCorr2 ('flash2', 'auto' above the threshold): no volume; each
  lookup recomputes the (2r+2)^2 patch of correlations from pooled target
  features with kernel K3.
- FlashCorr ('flash'): K5 (K3's function) for the leading levels, a dense
  sidecar (K1 with `level_offset`) for the deep ones while they fit.
- BandCorrPyramid ('band'): levels materialized plane-row-outer
  [B, lh, Nq, lw], patches by K6 (K4's function).
- CorrPyramid ('gather') and OnTheFlyCorr ('direct'): plain torch, the
  yardsticks of the tests.  CorrPyramid also keeps the JAX package's two
  other gather formulations, `lookup_span` and `lookup_rows`.

Every `lookup` takes `border`: 'zeros' (the models' border: out-of-plane
taps contribute 0) or 'clamp' (the plane's edge entry is repeated).  A
clamp lookup of a DenseCorrPyramid takes the exact-patch path (K4 and the
epilogue) where 'auto' would take the fused K1, as the JAX package's does.

`row0` (every `build`, `make_corr`): the image row of fmap1's first row.  It
is 0 but in a spatially sharded call (core/strips.py), where fmap1 holds one
row strip's queries and fmap2 the whole frame's targets; the lookups place
each query at its own image row.

The TPU package regroups, packs and pads these stores for Mosaic; a GPU
kernel indexes the plain layouts directly, so those layouts are not ported.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..kernels.bandlookup import band_patch_levels
from ..kernels.denselookup import dense_lookup, dense_patch_levels
from ..kernels.flashcorr import flash_patch_level
from ..kernels.flashcorr2 import flash2_patch_level
from ..runtime.profiling import count

MATERIALIZE_THRESHOLD = 168 * 168
DENSE_LOOKUP_IMPLS = ("auto", "patch", "xla")
BORDERS = ("zeros", "clamp")
# The JAX package's kernel names for a dense lookup (TPUFLOW_DENSE_LOOKUP):
# both are the fused kernel, the port's 'auto'.
_JAX_KERNEL_NAMES = ("pallas", "interpret")


def _check_border(border: str) -> None:
    if border not in BORDERS:
        raise ValueError(f"border {border!r}: expected one of {BORDERS}")


def pyramid_level_dims(h2: int, w2: int, level: int) -> Tuple[int, int]:
    """Spatial dims of pyramid level `level` (VALID 2x pooling)."""
    for _ in range(level):
        h2, w2 = h2 // 2, w2 // 2
    return h2, w2


def corr_feature_dim(num_levels: int, radius: int) -> int:
    return num_levels * (2 * radius + 1) ** 2


def dense_volume_bytes(h8: int, w8: int, num_levels: int = 4, dtype=torch.bfloat16) -> int:
    """Device bytes of ONE direction's DenseCorrPyramid for an [h8, w8]
    feature grid, per batch item: the port stores each level unpadded as
    [h8*w8, lh, lw] (the JAX package's copy, tpuflow/core/corr.py:807,
    counts its TPU-aligned grouped layout instead)."""
    nq = h8 * w8
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sum(nq * lh * lw * itemsize
               for lh, lw in (pyramid_level_dims(h8, w8, lvl) for lvl in range(num_levels)))


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """Full cost volume [B, H, W, H, W] between two [B, H, W, C] maps,
    f32-accumulated, scaled by 1/sqrt(C), in the features' dtype."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).float()
    f2 = fmap2.reshape(b, h * w, c).float()
    corr = torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(c)
    return corr.to(fmap1.dtype).reshape(b, h, w, h, w)


def _pool_planes(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean over the last two dims of [..., lh, lw] (odd trailing row or
    column dropped), summed in f32 and rounded to x's dtype."""
    lh, lw = x.shape[-2], x.shape[-1]
    x = x[..., : (lh // 2) * 2, : (lw // 2) * 2]
    x = x.reshape(*x.shape[:-2], lh // 2, 2, lw // 2, 2)
    return x.float().mean(dim=(-3, -1)).to(x.dtype)


def build_corr_pyramid(corr: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """[B, H, W, H2, W2] -> flat levels [B*H*W, (H2/2^l)*(W2/2^l)], each the
    2x2 average pool of the one before."""
    b, h, w, h2, w2 = corr.shape
    x = corr.reshape(b * h * w, h2, w2)
    pyramid = [x.reshape(b * h * w, h2 * w2)]
    for _ in range(num_levels - 1):
        x = _pool_planes(x)
        pyramid.append(x.reshape(b * h * w, -1))
    return pyramid


def _avg_pool_features(fmap: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of [B, H, W, C] in the features' dtype (VALID, as
    the volume pooling)."""
    b, h, w, c = fmap.shape
    x = fmap[:, : (h // 2) * 2, : (w // 2) * 2].reshape(b, h // 2, 2, w // 2, 2, c)
    return x.float().mean(dim=(2, 4)).to(fmap.dtype)


def _pooled_features(fmap2: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    pooled = [fmap2]
    for _ in range(num_levels - 1):
        pooled.append(_avg_pool_features(pooled[-1]))
    return pooled


def _base_coords(flow: torch.Tensor, row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """flow [B, h, w, 2] -> each pixel's target (x + fx, y + fy), [B, h*w],
    the grid's rows at image rows row0 .. row0 + h - 1."""
    b, h, w, _ = flow.shape
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + h, device=flow.device, dtype=torch.float32),
        torch.arange(w, device=flow.device, dtype=torch.float32),
        indexing="ij",
    )
    return (
        (xs[None] + flow[..., 0]).reshape(b, h * w),
        (ys[None] + flow[..., 1]).reshape(b, h * w),
    )


class _PatchIdx(NamedTuple):
    """Per-level lookup geometry shared by the patch kernels."""

    yraw: torch.Tensor  # [B, hw, side] unclamped patch-row indices
    xraw: torch.Tensor
    rr: torch.Tensor    # int32, clamped to [0, lh)
    cc: torch.Tensor    # int32, clamped to [0, lw)
    wx: torch.Tensor    # [B, hw, 1, 1] bilinear fractions
    wy: torch.Tensor


def _radius_patch_indices(base_x, base_y, lvl: int, lh: int, lw: int, r: int) -> _PatchIdx:
    """Window geometry for one pyramid level: the (2r+2)-side patch's row and
    column indices around each query's scaled flow target, and the bilinear
    fractions every window position of a query shares."""
    jj = torch.arange(2 * r + 2, device=base_x.device, dtype=torch.int32)
    cx = base_x / (2.0**lvl)
    cy = base_y / (2.0**lvl)
    fx0 = torch.floor(cx)
    fy0 = torch.floor(cy)
    wx = (cx - fx0)[:, :, None, None]
    wy = (cy - fy0)[:, :, None, None]
    xraw = (fx0.to(torch.int32) - r)[:, :, None] + jj
    yraw = (fy0.to(torch.int32) - r)[:, :, None] + jj
    rr = yraw.clamp(0, lh - 1).contiguous()
    cc = xraw.clamp(0, lw - 1).contiguous()
    return _PatchIdx(yraw, xraw, rr, cc, wx, wy)


def _patch_to_features(patch: torch.Tensor, idx: _PatchIdx, lh: int, lw: int, shape,
                       border: str = "zeros") -> torch.Tensor:
    """(2r+2)^2 exact-value patch [B, hw, side, side] -> (2r+1)^2 bilinear
    features [B, h, w, (2r+1)^2] f32: out-of-plane taps zeroed (border
    'zeros'; 'clamp' keeps the clamped entries), the shared-fraction
    bilinear in the PATCH's dtype (bf16 arithmetic for bf16 storage, as the
    reference's epilogue), upstream x-major channel order."""
    b, h, w, r = shape
    dt = patch.dtype
    if border == "zeros":
        vr = ((idx.yraw >= 0) & (idx.yraw < lh)).to(dt)
        vc = ((idx.xraw >= 0) & (idx.xraw < lw)).to(dt)
        patch = patch * vr[:, :, :, None] * vc[:, :, None, :]
    v00 = patch[:, :, :-1, :-1]
    v01 = patch[:, :, :-1, 1:]
    v10 = patch[:, :, 1:, :-1]
    v11 = patch[:, :, 1:, 1:]
    wxd = idx.wx.to(dt)
    wyd = idx.wy.to(dt)
    sampled = (
        v00 * (1 - wxd) * (1 - wyd)
        + v01 * wxd * (1 - wyd)
        + v10 * (1 - wxd) * wyd
        + v11 * wxd * wyd
    )                                           # [B, hw, 2r+1 (y), 2r+1 (x)]
    sampled = sampled.transpose(2, 3)           # first window axis -> x offset
    return sampled.reshape(b, h, w, (2 * r + 1) ** 2).float()


def _patch_lookup(patches_fn, levels, dims, flow, radius: int, level_offset: int = 0, row0: int = 0,
                  border: str = "zeros") -> torch.Tensor:
    """Lookup through a patch kernel: the geometry of every stored level
    (plane dims `dims[i]`, sampled at scale 2^(i + level_offset)), then
    `patches_fn(levels, rrs, ccs)`'s (2r+2)^2 patch per level (one call for
    all levels), then the shared epilogue per level."""
    _check_border(border)
    b, h, w, _ = flow.shape
    base_x, base_y = _base_coords(flow, row0)
    idxs = [_radius_patch_indices(base_x, base_y, lvl0 + level_offset, lh, lw, radius)
            for lvl0, (lh, lw) in enumerate(dims)]
    patches = patches_fn(levels, [idx.rr for idx in idxs], [idx.cc for idx in idxs])
    return torch.cat([_patch_to_features(patch, idx, lh, lw, (b, h, w, radius), border)
                      for patch, idx, (lh, lw) in zip(patches, idxs, dims)], dim=-1)


class CorrPyramid:
    """Materialized pyramid, levels pooled from the level-0 VOLUME, with the
    patch-gather lookup: the formulation the others are tested against."""

    def __init__(self, pyramid: List[torch.Tensor], target_dims: Tuple[int, int], row0: int = 0):
        self.pyramid = pyramid          # flat levels [B*h*w, lh*lw]
        self.h2, self.w2 = target_dims  # level-0 target plane
        self.row0 = row0

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, row0: int = 0):
        b, h, w, c = fmap1.shape
        h2, w2 = fmap2.shape[1], fmap2.shape[2]
        scale = 1.0 / math.sqrt(c)
        levels: List[List[torch.Tensor]] = [[] for _ in range(num_levels)]
        # One batch element at a time bounds the f32 product to one plane.
        for f1, f2 in zip(fmap1, fmap2):
            corr = torch.matmul(f1.reshape(h * w, c).float(), f2.reshape(h2 * w2, c).float().t())
            x = (corr * scale).to(fmap1.dtype).reshape(h * w, h2, w2)
            for lvl in range(num_levels):
                levels[lvl].append(x.reshape(h * w, -1))
                if lvl + 1 < num_levels:
                    x = _pool_planes(x)
        return cls([torch.cat(parts) for parts in levels], (h2, w2), row0)

    def _levels(self, flow: torch.Tensor, radius: int):
        """Per level: (flat volume, lh, lw, its _PatchIdx as [N, side] rows)."""
        base_x, base_y = _base_coords(flow, self.row0)
        n = base_x.numel()
        for lvl, volume in enumerate(self.pyramid):
            lh, lw = pyramid_level_dims(self.h2, self.w2, lvl)
            idx = _radius_patch_indices(base_x.reshape(1, n), base_y.reshape(1, n), lvl, lh, lw, radius)
            yield volume, lh, lw, _PatchIdx(*(t[0] for t in idx))

    @staticmethod
    def _sample(patch: torch.Tensor, idx: _PatchIdx, lh: int, lw: int, border: str) -> torch.Tensor:
        """[N, side (rows), side (cols)] exact entries -> [N, (2r+1)^2] f32:
        taps outside the plane zeroed (border 'zeros'), the four-corner f32
        bilinear (every window position of a query shares one fraction),
        upstream x-major order."""
        patch = patch.float()
        if border == "zeros":
            vr = ((idx.yraw >= 0) & (idx.yraw < lh)).float()
            vc = ((idx.xraw >= 0) & (idx.xraw < lw)).float()
            patch = patch * vr[:, :, None] * vc[:, None, :]
        wx, wy = idx.wx, idx.wy                 # [N, 1, 1]
        sampled = (
            patch[:, :-1, :-1] * (1 - wx) * (1 - wy)
            + patch[:, :-1, 1:] * wx * (1 - wy)
            + patch[:, 1:, :-1] * (1 - wx) * wy
            + patch[:, 1:, 1:] * wx * wy
        )
        return sampled.transpose(1, 2).reshape(patch.shape[0], -1)

    def _lookup_with(self, extract, flow: torch.Tensor, radius: int, border: str) -> torch.Tensor:
        _check_border(border)
        b, h, w, _ = flow.shape
        out = [self._sample(extract(volume, lh, lw, idx), idx, lh, lw, border).reshape(b, h, w, -1)
               for volume, lh, lw, idx in self._levels(flow, radius)]
        return torch.cat(out, dim=-1)

    def lookup(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros") -> torch.Tensor:
        """One (2r+2)^2 patch gather per query and level, then the four-corner
        f32 bilinear (the window deltas are integers, so every position of a
        query shares one fraction)."""

        def extract(volume, lh, lw, idx):
            n, side = idx.rr.shape
            flat = idx.rr.long()[:, :, None] * lw + idx.cc.long()[:, None, :]
            return torch.gather(volume, 1, flat.reshape(n, side * side)).reshape(n, side, side)

        return self._lookup_with(extract, flow, radius, border)

    def lookup_span(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros") -> torch.Tensor:
        """The JAX package's span formulation (tpuflow/core/corr.py:253): per
        query and patch row one contiguous span of min(16, lw) entries,
        starting at the clamped window column, then each patch column picked
        from the span; a column the span does not hold (patches wider than
        16 at a plane's edge) reads 0, as the reference's one-hot does.
        Otherwise equal to `lookup`."""

        def extract(volume, lh, lw, idx):
            n, side = idx.rr.shape
            span = min(16, lw)
            col0 = idx.xraw[:, :1].clamp(0, lw - span)                       # [N, 1]
            starts = idx.rr.long() * lw + col0.long()                         # [N, side]
            cols = starts[:, :, None] + torch.arange(span, device=volume.device)
            spans = torch.gather(volume, 1, cols.reshape(n, side * span)).reshape(n, side, span)
            rel = idx.cc - col0                                               # [N, side]
            inside = (rel >= 0) & (rel < span)
            picked = torch.gather(spans, 2, rel.clamp(0, span - 1).long()[:, None, :].expand(n, side, side))
            return torch.where(inside[:, None, :], picked, torch.zeros((), dtype=picked.dtype,
                                                                       device=picked.device))

        return self._lookup_with(extract, flow, radius, border)

    def lookup_rows(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros") -> torch.Tensor:
        """The JAX package's row-band formulation (tpuflow/core/corr.py:334):
        per query a band of min(2r+2, lh) whole plane rows at a clamped
        origin, the patch rows picked from the band and the columns from the
        rows.  Equal to `lookup`."""

        def extract(volume, lh, lw, idx):
            n, side = idx.rr.shape
            band = min(side, lh)
            origin = idx.yraw[:, :1].clamp(0, lh - band).long()              # [N, 1]
            offs = origin * lw + torch.arange(band * lw, device=volume.device)
            rows = torch.gather(volume, 1, offs).reshape(n, band, lw)
            rows = torch.gather(rows, 1, (idx.rr.long() - origin)[:, :, None].expand(n, side, lw))
            return torch.gather(rows, 2, idx.cc.long()[:, None, :].expand(n, side, side))

        return self._lookup_with(extract, flow, radius, border)


class DenseCorrPyramid:
    """Materialized pyramid: levels [B*h*w, lh, lw] in the features' dtype.
    `level_offset` = k marks a pyramid that holds only levels k.. of a larger
    one (FlashCorr's sidecar): stored level i is sampled at scale 2^(i+k)."""

    def __init__(self, pyramid: List[torch.Tensor], level_offset: int = 0, row0: int = 0):
        self.pyramid = pyramid
        self.level_offset = level_offset
        self.row0 = row0

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, row0: int = 0):
        """Each level is one matmul of the source features against the target
        features 2^l-average-pooled in f32 (the reference's F.avg_pool2d
        chain up to summation order), scaled by 1/sqrt(C)."""
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
        count("corr.dense_bytes", sum(v.numel() * v.element_size() for v in pyramid))
        return cls(pyramid, row0=row0)

    def lookup(self, flow: torch.Tensor, radius: int = 4, impl: Optional[str] = None,
               border: str = "zeros") -> torch.Tensor:
        """flow [B, h, w, 2] f32 -> [B, h, w, L*(2r+1)^2] f32.  `impl`:
        'auto' = the fused kernel K1 (f32 bilinear); 'patch' = the
        exact-patch kernel K4 and the shared epilogue (bilinear in the
        volume's dtype); 'xla' = the JAX package's XLA formulation
        (tpuflow/core/corr.py:607-702): each patch gathered in plain torch,
        then the same epilogue, so it equals 'patch' bit for bit and is
        differentiable in the volumes and the flow.  Only the caller picks
        'xla' (the train step does); 'auto' never falls back to it.  K1's
        plain version is `dense_lookup_plain`, called directly by tests and
        yardsticks, never from here.

        The TPUFLOW_DENSE_LOOKUP environment variable, where set, beats
        `impl` (the JAX package's sweep override, tpuflow/core/corr.py:597;
        its kernel names 'pallas' and 'interpret' mean 'auto' here).  A
        border='clamp' lookup under 'auto' takes 'patch': the fused kernel
        zeroes its border, as the JAX package's does."""
        env = os.environ.get("TPUFLOW_DENSE_LOOKUP")
        mode = ("auto" if env in _JAX_KERNEL_NAMES else env) or impl or "auto"
        if mode not in DENSE_LOOKUP_IMPLS:
            raise ValueError(f"dense_lookup {mode!r}: expected one of {DENSE_LOOKUP_IMPLS}")
        _check_border(border)
        flow = flow.contiguous()
        if mode == "auto" and border == "zeros":
            return dense_lookup(self.pyramid, flow, radius, self.level_offset, row0=self.row0)
        dims = [(v.shape[1], v.shape[2]) for v in self.pyramid]
        patches = _gather_patches if mode == "xla" else dense_patch_levels
        return _patch_lookup(patches, self.pyramid, dims, flow, radius, self.level_offset, self.row0, border)


def _gather_patches(volumes, rrs, ccs) -> List[torch.Tensor]:
    """Per level [B*Nq, lh, lw] and clamped rr, cc [B, Nq, side] -> the
    exact-value patch [B, Nq, side, side] of each query's own plane: one
    plain gather per level, differentiable in the volumes."""
    out = []
    for vol, rr, cc in zip(volumes, rrs, ccs):
        (b, nq, side), (n, lh, lw) = rr.shape, vol.shape
        idx = rr.long()[:, :, :, None] * lw + cc.long()[:, :, None, :]
        out.append(torch.gather(vol.reshape(n, lh * lw), 1, idx.reshape(n, side * side)).reshape(b, nq, side, side))
    return out


class OnTheFlyCorr:
    """Lookup without any volume, in plain torch: pooling the volume over its
    target dims equals correlating against pooled target features, so each
    level keeps only the pooled fmap2; a lookup gathers the four bilinear
    corners' feature rows per window position and contracts them with
    fmap1."""

    def __init__(self, fmap1: torch.Tensor, pyramid: List[torch.Tensor], row0: int = 0):
        self.fmap1 = fmap1      # [B, h, w, C]
        self.pyramid = pyramid  # pooled fmap2 per level [B, lh, lw, C]
        self.row0 = row0

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, row0: int = 0):
        return cls(fmap1, _pooled_features(fmap2, num_levels), row0)

    def lookup(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros",
               chunk_budget: int = 4 * 10**8) -> torch.Tensor:
        """Queries go in chunks so that one corner's gather [B, chunk, P, C]
        stays within `chunk_budget` bytes; chunking only reorders independent
        per-query work.  border='clamp': an out-of-plane corner reads the
        plane's edge."""
        _check_border(border)
        b, h, w, _ = flow.shape
        r = radius
        c = self.fmap1.shape[-1]
        dev = flow.device
        d = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
        dxg, dyg = torch.meshgrid(d, d, indexing="ij")   # x takes the first window axis
        dx, dy = dxg.reshape(-1), dyg.reshape(-1)
        p = dx.shape[0]
        hw = h * w
        base_x, base_y = _base_coords(flow, self.row0)
        f1 = self.fmap1.reshape(b, hw, c)
        scale = 1.0 / math.sqrt(c)
        bidx = torch.arange(b, device=dev)[:, None, None]
        chunk = max(1, min(hw, chunk_budget // max(1, b * p * c * 2)))

        def level_corr(f2l, bx, by, f1_block):
            lh, lw = f2l.shape[1], f2l.shape[2]
            x = bx[..., None] + dx
            y = by[..., None] + dy
            x0, y0 = torch.floor(x), torch.floor(y)
            wx, wy = x - x0, y - y0
            x0u, y0u = x0.long(), y0.long()
            corr = torch.zeros_like(x)
            for yu, xu, wgt in (
                (y0u, x0u, (1 - wx) * (1 - wy)),
                (y0u, x0u + 1, wx * (1 - wy)),
                (y0u + 1, x0u, (1 - wx) * wy),
                (y0u + 1, x0u + 1, wx * wy),
            ):
                if border == "zeros":
                    # Zero padding: an out-of-plane corner contributes nothing.
                    wgt = wgt * ((yu >= 0) & (yu < lh) & (xu >= 0) & (xu < lw)).float()
                v = f2l[bidx, yu.clamp(0, lh - 1), xu.clamp(0, lw - 1)]   # [B, Q, P, C]
                corr = corr + wgt * torch.einsum("bqc,bqpc->bqp", f1_block.float(), v.float())
            return corr * scale

        out = torch.empty((b, hw, len(self.pyramid) * p), dtype=torch.float32, device=dev)
        for s in range(0, hw, chunk):
            e = min(hw, s + chunk)
            for lvl, f2l in enumerate(self.pyramid):
                out[:, s:e, lvl * p : (lvl + 1) * p] = level_corr(
                    f2l, base_x[:, s:e] / (2.0**lvl), base_y[:, s:e] / (2.0**lvl), f1[:, s:e]
                )
        return out.reshape(b, h, w, -1)


def _recomputed_lookup(kernel, fmap1, pooled, flow, radius: int, row0: int = 0,
                       border: str = "zeros") -> torch.Tensor:
    """Lookup through a recomputed-correlation kernel (K3 or K5) against the
    pooled target features of each level; the kernel learns the query
    grid's width, w, for its tiles."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c)
    dims = [(p.shape[1], p.shape[2]) for p in pooled]

    def patches(levels, rrs, ccs):
        return [kernel(f1, f2l, rr, cc, grid_w=w) for f2l, rr, cc in zip(levels, rrs, ccs)]

    return _patch_lookup(patches, pooled, dims, flow, radius, row0=row0, border=border)


class FlashCorr:
    """Hybrid lookup: the leading `flash_levels` levels are recomputed per
    lookup by kernel K5 from pooled target features [B, lh, lw, C]; the
    remaining deep levels, which are small, are a DenseCorrPyramid sidecar
    (kernel K1 with `level_offset`).  Patch entries are what a materialized
    volume holds at level 0; deeper flash levels pool FEATURES in the
    features' dtype, equal to volume pooling up to float reassociation."""

    def __init__(self, fmap1: torch.Tensor, flash_pyr: List[torch.Tensor],
                 dense: Optional[DenseCorrPyramid] = None, row0: int = 0):
        self.fmap1 = fmap1
        self.flash_pyr = flash_pyr
        self.dense = dense
        self.row0 = row0

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
              flash_levels: Optional[int] = None, dense_budget: int = 2 * 10**9, row0: int = 0):
        """flash_levels=None: level 0 goes through the kernel (three quarters
        of the volume); deeper levels stay dense while their volumes fit
        `dense_budget` bytes, else every level goes through the kernel."""
        b, h, w, _ = fmap1.shape
        h2, w2 = fmap2.shape[1], fmap2.shape[2]
        pooled = _pooled_features(fmap2, num_levels)
        if flash_levels is None:
            deep = sum(math.prod(pyramid_level_dims(h2, w2, l)) for l in range(1, num_levels))
            deep_bytes = b * h * w * deep * fmap1.element_size()
            flash_levels = 1 if deep_bytes <= dense_budget else num_levels
        flash_levels = max(1, min(num_levels, flash_levels))
        dense = None
        if flash_levels < num_levels:
            sub = DenseCorrPyramid.build(fmap1, pooled[flash_levels], num_levels - flash_levels)
            dense = DenseCorrPyramid(sub.pyramid, level_offset=flash_levels, row0=row0)
        return cls(fmap1, [p.contiguous() for p in pooled[:flash_levels]], dense, row0)

    def lookup(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros") -> torch.Tensor:
        flash_out = _recomputed_lookup(flash_patch_level, self.fmap1, self.flash_pyr, flow, radius,
                                       self.row0, border)
        if self.dense is None:
            return flash_out
        return torch.cat([flash_out, self.dense.lookup(flow, radius, border=border)], dim=-1)


class FlashCorr2:
    """Every level recomputed per lookup by kernel K3 from pooled target
    features [B, lh, lw, C]: no volume, no build beyond the pooling, no
    sidecar.  The formulation for grids too large to materialize."""

    def __init__(self, fmap1: torch.Tensor, pooled_pyr: List[torch.Tensor], row0: int = 0):
        self.fmap1 = fmap1            # [B, h, w, C]
        self.pooled_pyr = pooled_pyr  # per level [B, lh, lw, C]
        self.row0 = row0

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, row0: int = 0):
        return cls(fmap1, [p.contiguous() for p in _pooled_features(fmap2, num_levels)], row0)

    def lookup(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros") -> torch.Tensor:
        return _recomputed_lookup(flash2_patch_level, self.fmap1, self.pooled_pyr, flow, radius,
                                  self.row0, border)


class BandCorrPyramid:
    """Materialized pyramid stored plane-row-outer, levels [B, lh, Nq, lw],
    with patches read by kernel K6.  Built query chunk by query chunk: each
    chunk's level-0 planes are pooled as a VOLUME in the storage dtype (not
    from pooled features as DenseCorrPyramid.build does), so deep levels
    differ from the dense pyramid's by float reassociation."""

    def __init__(self, pyramid: List[torch.Tensor], row0: int = 0):
        self.pyramid = pyramid
        self.row0 = row0

    @classmethod
    def build(cls, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, row0: int = 0):
        b, h, w, c = fmap1.shape
        h2, w2 = fmap2.shape[1], fmap2.shape[2]
        scale = 1.0 / math.sqrt(c)
        dt = fmap1.dtype
        nq = h * w
        f1 = fmap1.reshape(b, nq, c)
        f2t = fmap2.reshape(b, h2 * w2, c).transpose(1, 2)
        pyramid = [
            torch.empty((b, lh, nq, lw), dtype=dt, device=fmap1.device)
            for lh, lw in (pyramid_level_dims(h2, w2, l) for l in range(num_levels))
        ]
        # Query rows per chunk: an f32 product of at most 5e8 bytes.
        rows = max(1, min(nq, int(5e8 / max(1, 4 * h2 * w2))))
        for bi in range(b):
            for s in range(0, nq, rows):
                blk = torch.matmul(f1[bi, s : s + rows].float(), f2t[bi].float())
                x = (blk * scale).to(dt).reshape(-1, h2, w2)
                for lvl in range(num_levels):
                    pyramid[lvl][bi, :, s : s + rows] = x.transpose(0, 1)
                    if lvl + 1 < num_levels:
                        x = _pool_planes(x)
        return cls(pyramid, row0)

    def lookup(self, flow: torch.Tensor, radius: int = 4, border: str = "zeros") -> torch.Tensor:
        dims = [(v.shape[1], v.shape[3]) for v in self.pyramid]
        return _patch_lookup(band_patch_levels, self.pyramid, dims, flow, radius, row0=self.row0, border=border)


def make_corr(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    num_levels: int = 4,
    impl: str = "auto",
    materialize_threshold: int = MATERIALIZE_THRESHOLD,
    row0: int = 0,
):
    """Pick the correlation formulation.  'auto' materializes the volume
    (DenseCorrPyramid, lookup cost independent of the flow) while the feature
    grid has at most `materialize_threshold` cells, and recomputes patches
    with FlashCorr2 above it, on every device.  The grid is the target's,
    fmap2's: the whole frame's, also where fmap1 holds one row strip of it
    (`row0`, module docstring).  The other values force one formulation:
    'materialized' | 'dense', 'gather', 'direct', 'flash', 'flash2', 'band'."""
    if impl in ("materialized", "dense"):
        return DenseCorrPyramid.build(fmap1, fmap2, num_levels, row0)
    if impl == "gather":
        return CorrPyramid.build(fmap1, fmap2, num_levels, row0)
    if impl == "direct":
        return OnTheFlyCorr.build(fmap1, fmap2, num_levels, row0)
    if impl == "flash":
        return FlashCorr.build(fmap1, fmap2, num_levels, row0=row0)
    if impl == "flash2":
        return FlashCorr2.build(fmap1, fmap2, num_levels, row0)
    if impl == "band":
        return BandCorrPyramid.build(fmap1, fmap2, num_levels, row0)
    if fmap2.shape[1] * fmap2.shape[2] > materialize_threshold:
        return FlashCorr2.build(fmap1, fmap2, num_levels, row0)
    return DenseCorrPyramid.build(fmap1, fmap2, num_levels, row0)
