"""K3: recomputed correlation patch (port of `flash2_patch_level`,
tpuflow/kernels/flashcorr2.py:246).

For query features f1 [B, Nq, C], one pyramid level of pooled target
features f2l [B, lh, lw, C] and clamped patch indices rr, cc [B, Nq, side]:

    patch[b,q,i,j] = cast((f1[b,q] . f2l[b, rr[b,q,i], cc[b,q,j]]) / sqrt(C))

with the sum in f32 and one rounding to f1's dtype: the entries a
materialized volume would hold there, without the volume.
`flash2_patch_level` launches csrc/corr_patch.cu for CUDA tensors and runs
`flash2_patch_level_plain` for CPU tensors.

The queries of an image form a grid [Nq / grid_w, grid_w].  In bf16 the
kernel takes 4 x 8 tiles of that grid and, where a tile's patches fall in a
box of at most MAX_BOX_PIXELS target pixels, computes the tile's
correlations with that whole box on the tensor cores; `tile_boxes` and
`tensor_path_tiles` apply the kernel's rule on the host, for logging and
tests.  The TPU kernel's phase-packed rows (`pack_f2_level`) serve Mosaic's
one-hot gather; the port stores each level unpacked.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import check_launch, count_launch, library
from ._nograd import refuses_gradient
from .denselookup import check_patch_indices

MAX_SIDE = 16          # both index vectors of a query fit one warp
MAX_CHANNELS = 1536    # 8 queries' features as f32 in 48 KB of shared memory
# The tile kernel's constants (csrc/corr_patch.cu kTileH, kTileW, kMaxBox,
# kMaxTensorC): bf16 with C a multiple of 16 up to TENSOR_MAX_CHANNELS runs
# in TILE_ROWS x TILE_COLS query tiles, and a tile whose box holds at most
# MAX_BOX_PIXELS pixels takes the tensor-core path.
TILE_ROWS, TILE_COLS = 4, 8
MAX_BOX_PIXELS = 1024
TENSOR_MAX_CHANNELS = 256
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def flash2_patch_level_plain(
    f1: torch.Tensor, f2l: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
    budget: int = 4 * 10**8,
) -> torch.Tensor:
    """Plain PyTorch version: gather each patch's target rows and contract
    them with the query in f32, over query chunks whose f32 gather
    [B, chunk, side, side, C] stays within `budget` bytes."""
    b, nq, c = f1.shape
    side = rr.shape[2]
    lh, lw = f2l.shape[1], f2l.shape[2]
    scale = 1.0 / math.sqrt(c)
    f2flat = f2l.reshape(b, lh * lw, c)
    bidx = torch.arange(b, device=f1.device)[:, None, None, None]
    out = torch.empty((b, nq, side, side), dtype=f1.dtype, device=f1.device)
    chunk = max(1, min(nq, budget // (b * side * side * c * 4)))
    for s in range(0, nq, chunk):
        e = min(nq, s + chunk)
        idx = rr[:, s:e, :, None].long() * lw + cc[:, s:e, None, :].long()
        rows = f2flat[bidx, idx].float()                        # [B, n, side, side, C]
        dots = torch.einsum("bqc,bqijc->bqij", f1[:, s:e].float(), rows)
        out[:, s:e] = (dots * scale).to(f1.dtype)
    return out


def takes_tiles(dtype: torch.dtype, c: int) -> bool:
    """Whether the kernel runs query tiles (and so the tensor path) for
    features of this dtype and channel count; otherwise every query takes
    the per-query path."""
    return dtype == torch.bfloat16 and c % 16 == 0 and c <= TENSOR_MAX_CHANNELS


def tile_boxes(rr: torch.Tensor, cc: torch.Tensor, grid_w: int, lh: int, lw: int) -> torch.Tensor:
    """Pixels of each tile's union box [B, tiles_y, tiles_x]: the kernel's
    rule on the host.  rr, cc [B, Nq, side] are clamped to the lh x lw plane
    as the kernel clamps them; the box spans the min to the max row and
    column over the tile's queries that lie on the grid."""
    b, nq, side = rr.shape
    gh = nq // grid_w
    ty, tx = -(-gh // TILE_ROWS), -(-grid_w // TILE_COLS)
    pad = (0, 0, 0, tx * TILE_COLS - grid_w, 0, ty * TILE_ROWS - gh)

    def span(idx, hi):
        v = idx.clamp(0, hi - 1).reshape(b, gh, grid_w, side)
        lo = torch.nn.functional.pad(v, pad, value=hi).reshape(b, ty, TILE_ROWS, tx, TILE_COLS, side)
        up = torch.nn.functional.pad(v, pad, value=-1).reshape(b, ty, TILE_ROWS, tx, TILE_COLS, side)
        return up.amax(dim=(2, 4, 5)) - lo.amin(dim=(2, 4, 5)) + 1

    return span(rr, lh) * span(cc, lw)


def tensor_path_tiles(rr: torch.Tensor, cc: torch.Tensor, grid_w: int, lh: int, lw: int) -> torch.Tensor:
    """Which tiles [B, tiles_y, tiles_x] take the tensor-core path (for
    features where `takes_tiles` holds)."""
    return tile_boxes(rr, cc, grid_w, lh, lw) <= MAX_BOX_PIXELS


def _lib():
    fn = library("corr_patch").tf_corr_patch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def corr_patch(wrapper, plain, f1, f2l, rr, cc, grid_w: Optional[int] = None) -> torch.Tensor:
    """Checks and dispatch shared by the two wrappers of csrc/corr_patch.cu
    (`flash2_patch_level` here, `flash_patch_level` in flashcorr.py):
    `plain` for CPU tensors, the kernel for CUDA tensors, counted on
    `wrapper`.  grid_w: the width of the query grid (None: one row of Nq)."""
    name = wrapper.__name__
    if f1.dim() != 3 or f2l.dim() != 4 or f2l.shape[0] != f1.shape[0] or f2l.shape[3] != f1.shape[2]:
        raise ValueError(
            f"{name}: f1 [B, Nq, C] and f2l [B, lh, lw, C] expected, got "
            f"{tuple(f1.shape)} {tuple(f2l.shape)}"
        )
    if f1.dtype not in _DTYPE_CODES or f2l.dtype != f1.dtype:
        raise ValueError(f"{name}: f1, f2l must share bfloat16 or float32: {f1.dtype} {f2l.dtype}")
    if f2l.device != f1.device:
        raise ValueError(f"{name}: f1 on {f1.device}, f2l on {f2l.device}")
    check_patch_indices(rr, cc, f1.device)
    b, nq, c = f1.shape
    side = rr.shape[2]
    if tuple(rr.shape[:2]) != (b, nq) or not 1 <= side <= MAX_SIDE:
        raise ValueError(f"{name}: rr {tuple(rr.shape)}: expected [{b}, {nq}, side <= {MAX_SIDE}]")
    grid_w = nq if grid_w is None else grid_w
    if not (isinstance(grid_w, int) and grid_w >= 1 and nq % grid_w == 0):
        raise ValueError(f"{name}: grid_w = {grid_w!r} does not divide Nq = {nq}")
    if f1.device.type == "cpu":
        return plain(f1, f2l, rr, cc)
    if f1.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {f1.device}")
    if not (f1.is_contiguous() and f2l.is_contiguous()):
        raise ValueError(f"{name}: f1, f2l must be contiguous")
    if c > MAX_CHANNELS:
        raise ValueError(f"{name}: C = {c} exceeds the kernel's {MAX_CHANNELS} channels")
    _, lh, lw, _ = f2l.shape
    out = torch.empty((b, nq, side, side), dtype=f1.dtype, device=f1.device)
    extents = (ctypes.c_longlong * 5)(*(t.numel() for t in (f1, f2l, rr, cc, out)))
    fn = _lib()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODES[f1.dtype], f1.data_ptr(), f2l.data_ptr(), rr.data_ptr(), cc.data_ptr(),
            out.data_ptr(), b * nq, nq, grid_w, lh, lw, c, side, 1.0 / math.sqrt(c), extents,
            stream,
        )
    check_launch(rc, name)
    count_launch(wrapper)
    return out


@refuses_gradient
def flash2_patch_level(
    f1: torch.Tensor, f2l: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
    *, grid_w: Optional[int] = None,
) -> torch.Tensor:
    """f1 [B, Nq, C], f2l [B, lh, lw, C] (one dtype, bf16 or f32), clamped rr,
    cc [B, Nq, side] int32 -> patch [B, Nq, side, side] in f1's dtype.  The
    queries form a grid of width grid_w (must divide Nq; None: one row).
    CPU tensors: the plain version; CUDA tensors: the kernel."""
    return corr_patch(flash2_patch_level, flash2_patch_level_plain, f1, f2l, rr, cc, grid_w)
