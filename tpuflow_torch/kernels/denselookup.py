"""K1 and K4: lookups from a materialized correlation pyramid.

K1, the fused dense radius lookup (port of `dense_feature_level`,
tpuflow/kernels/denselookup.py:398):

For every query of a materialized correlation pyramid (levels [N, lh, lw],
N = B*h*w, bf16 or f32) and its current flow [B, h, w, 2], sample the
(2r+1)^2 window around the flow target at every level with zero borders
and the two-stage f32 bilinear of the fused TPU kernel, in the upstream
x-major channel order (c = lvl*(2r+1)^2 + col*(2r+1) + row).

`dense_lookup` launches csrc/dense_lookup.cu for CUDA tensors and runs
`dense_lookup_plain` for CPU tensors.  `level_offset` = k samples stored
level l at scale 2^(l+k): a pyramid that holds only the levels from k on.
`row0` is the image row of the query grid's first row: the queries of one
row strip of a frame (runtime/sharding.py shard_spatial_forward) look up
volumes of the whole frame's targets from their own rows.
The kernel stages each query's patches in shared memory, one patch row per
warp pass, so both versions take radii 0..MAX_RADIUS only.

K4, the exact-value patch (port of `dense_patch_level`,
tpuflow/kernels/denselookup.py:156): for a flat level [B*Nq, lh, lw] and
clamped indices rr, cc [B, Nq, side], patch[b,q,i,j] = vol[b*Nq+q, rr[b,q,i],
cc[b,q,j]] in the volume's dtype.  `dense_patch_levels` takes every level
of a lookup and launches csrc/volume_patch.cu once for CUDA tensors, or
runs `dense_patch_levels_plain` for CPU tensors; `dense_patch_level` is its
one-level form.  Kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from ._build import check_launch, count_launch, library
from ._nograd import refuses_gradient

MAX_LEVELS = 8
MAX_RADIUS = 14
MAX_PATCH_SIDE = 2 * MAX_RADIUS + 2   # K4/K6's widest patch
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def dense_lookup_plain(
    volumes: Sequence[torch.Tensor], flow: torch.Tensor, radius: int, level_offset: int = 0, row0: int = 0
) -> torch.Tensor:
    """Plain PyTorch version: a gather of each query's (2r+2)^2 patch, zeros
    outside the plane, then the f32 bilinear in the kernel's order."""
    b, h, w, _ = flow.shape
    n = b * h * w
    side = 2 * radius + 2
    ns = side - 1
    dev = flow.device
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32),
        indexing="ij",
    )
    base_x = (xs[None] + flow[..., 0]).reshape(n)
    base_y = (ys[None] + flow[..., 1]).reshape(n)
    offs = torch.arange(side, device=dev)
    out = []
    for lvl, vol in enumerate(volumes):
        lh, lw = vol.shape[1], vol.shape[2]
        cx = base_x / (2.0 ** (lvl + level_offset))
        cy = base_y / (2.0 ** (lvl + level_offset))
        x0 = torch.floor(cx)
        y0 = torch.floor(cy)
        wx = (cx - x0)[:, None, None]
        wy = (cy - y0)[:, None, None]
        cols = x0.long()[:, None] - radius + offs              # [N, side]
        rows = y0.long()[:, None] - radius + offs
        vc = (cols >= 0) & (cols < lw)
        vr = (rows >= 0) & (rows < lh)
        idx = rows.clamp(0, lh - 1)[:, :, None] * lw + cols.clamp(0, lw - 1)[:, None, :]
        patch = torch.gather(vol.reshape(n, lh * lw), 1, idx.reshape(n, side * side))
        patch = patch.reshape(n, side, side).float()           # [N, row i, col j]
        patch = torch.where(vr[:, :, None] & vc[:, None, :], patch, 0.0)
        p = patch.transpose(1, 2)                              # [N, col j, row i]
        t = p[:, :-1] + wx * (p[:, 1:] - p[:, :-1])            # column lerp
        s = t[:, :, :-1] + wy * (t[:, :, 1:] - t[:, :, :-1])   # row lerp
        out.append(s.reshape(b, h, w, ns * ns))
    return torch.cat(out, dim=-1)


def _lib():
    fn = library("dense_lookup").tf_dense_lookup
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check(volumes: Sequence[torch.Tensor], flow: torch.Tensor) -> None:
    if flow.dtype != torch.float32 or flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be [B, h, w, 2] float32, got {tuple(flow.shape)} {flow.dtype}")
    if not flow.is_contiguous():
        raise ValueError("flow must be contiguous")
    if not 1 <= len(volumes) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} pyramid levels supported, got {len(volumes)}")
    n = flow.shape[0] * flow.shape[1] * flow.shape[2]
    dt = volumes[0].dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"volumes must be bfloat16 or float32, got {dt}")
    for v in volumes:
        if v.device != flow.device:
            raise ValueError(f"volume on {v.device}, flow on {flow.device}")
        if v.dtype != dt or v.dim() != 3 or v.shape[0] != n:
            raise ValueError(f"volume {tuple(v.shape)} {v.dtype}: expected [{n}, lh, lw] {dt}")
        if not v.is_contiguous():
            raise ValueError("volumes must be contiguous")


@refuses_gradient
def dense_lookup(
    volumes: Sequence[torch.Tensor], flow: torch.Tensor, radius: int, level_offset: int = 0, row0: int = 0
) -> torch.Tensor:
    """[N, lh, lw] levels + flow [B, h, w, 2] f32 -> [B, h, w, L*(2r+1)^2]
    f32, the query grid's rows at image rows row0 .. row0 + h - 1.  CPU
    tensors: the plain version; CUDA tensors: the kernel, one launch for all
    levels."""
    _check(volumes, flow)
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} out of range 0..{MAX_RADIUS}")
    if not 0 <= level_offset <= 30 - len(volumes):
        raise ValueError(f"level_offset {level_offset} out of range")
    if not 0 <= row0 <= 2**24 - flow.shape[1]:
        raise ValueError(f"row0 {row0} out of range 0..2^24 - h")
    if flow.device.type == "cpu":
        return dense_lookup_plain(volumes, flow, radius, level_offset, row0)
    if flow.device.type != "cuda":
        raise ValueError(f"dense_lookup runs on cpu or cuda, not {flow.device}")
    b, h, w, _ = flow.shape
    nl = len(volumes)
    ncs = (2 * radius + 1) ** 2
    out = torch.empty((b, h, w, nl * ncs), dtype=torch.float32, device=flow.device)
    ptrs = (ctypes.c_void_p * nl)(*[v.data_ptr() for v in volumes])
    lhs = (ctypes.c_int * nl)(*[v.shape[1] for v in volumes])
    lws = (ctypes.c_int * nl)(*[v.shape[2] for v in volumes])
    extents = (ctypes.c_longlong * nl)(*[v.numel() for v in volumes])
    fn = _lib()
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODES[volumes[0].dtype], ptrs, lhs, lws, extents, nl,
            flow.data_ptr(), flow.numel(), out.data_ptr(), out.numel(),
            b * h * w, h, w, row0, radius, level_offset, stream,
        )
    check_launch(rc, "dense_lookup")
    count_launch(dense_lookup)
    return out


def check_patch_indices(rr: torch.Tensor, cc: torch.Tensor, device: torch.device) -> None:
    """rr, cc: [B, Nq, side] int32, contiguous, on `device` (shared by the
    four patch wrappers)."""
    if rr.dim() != 3 or rr.shape != cc.shape:
        raise ValueError(f"rr, cc must share shape [B, Nq, side]: {tuple(rr.shape)} {tuple(cc.shape)}")
    if rr.dtype != torch.int32 or cc.dtype != torch.int32:
        raise ValueError(f"rr, cc must be int32, got {rr.dtype} {cc.dtype}")
    if rr.device != device or cc.device != device:
        raise ValueError(f"rr on {rr.device}, cc on {cc.device}, data on {device}")
    if not (rr.is_contiguous() and cc.is_contiguous()):
        raise ValueError("rr, cc must be contiguous")


def _volume_patch_lib():
    fn = library("volume_patch").tf_volume_patch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def check_volume_levels(volumes: Sequence[torch.Tensor], rrs: Sequence[torch.Tensor],
                        ccs: Sequence[torch.Tensor], layout: str) -> None:
    """The levels of one patch lookup (shared by K4 and K6): 1..MAX_LEVELS
    contiguous volumes of one dtype (bf16 or f32) on one device, flat
    [B*Nq, lh, lw] (layout 'flat') or [B, lh, Nq, lw] ('band'), and per
    level clamped rr, cc [B, Nq, side] int32 of one shape, side even and at
    most MAX_PATCH_SIDE."""
    if not 1 <= len(volumes) <= MAX_LEVELS or len(rrs) != len(volumes) or len(ccs) != len(volumes):
        raise ValueError(f"1..{MAX_LEVELS} levels with one rr and one cc each, got "
                         f"{len(volumes)}, {len(rrs)}, {len(ccs)}")
    dev, dt = volumes[0].device, volumes[0].dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"volumes must be bfloat16 or float32, got {dt}")
    shape = tuple(rrs[0].shape)
    for vol, rr, cc in zip(volumes, rrs, ccs):
        check_patch_indices(rr, cc, dev)
        if tuple(rr.shape) != shape:
            raise ValueError(f"every level's rr, cc must share one shape: {tuple(rr.shape)} and {shape}")
        if vol.device != dev or vol.dtype != dt or not vol.is_contiguous():
            raise ValueError(f"volumes must be contiguous, of one dtype on one device: {vol.dtype} on "
                             f"{vol.device} beside {dt} on {dev}")
        b, nq, side = shape
        if layout == "flat" and (vol.dim() != 3 or vol.shape[0] != b * nq):
            raise ValueError(f"volume {tuple(vol.shape)}: expected [{b * nq}, lh, lw]")
        if layout == "band" and (vol.dim() != 4 or (vol.shape[0], vol.shape[2]) != (b, nq)):
            raise ValueError(f"vol {tuple(vol.shape)}: expected [{b}, lh, {nq}, lw]")
    if side % 2 or not 2 <= side <= MAX_PATCH_SIDE:
        raise ValueError(f"patch side {side}: expected an even side of 2..{MAX_PATCH_SIDE}")


def launch_volume_patch(volumes: Sequence[torch.Tensor], rrs: Sequence[torch.Tensor],
                        ccs: Sequence[torch.Tensor], layout: str, kernel: str) -> List[torch.Tensor]:
    """csrc/volume_patch.cu, one launch for every level of checked CUDA
    levels (check_volume_levels) -> per level [B, Nq, side, side] in the
    volumes' dtype.  The outputs share one buffer, each level starting at a
    multiple of 16 bytes, as the kernel's 16-byte stores need."""
    b, nq, side = rrs[0].shape
    if layout == "flat":
        dims = [(v.shape[1], v.shape[2]) for v in volumes]
        strides = [(nq * lh * lw, lh * lw, lw) for lh, lw in dims]
    else:
        dims = [(v.shape[1], v.shape[3]) for v in volumes]
        strides = [(lh * nq * lw, lw, nq * lw) for lh, lw in dims]
    if b * nq * side >= 2**31 or max(max(sq, sr) for _, sq, sr in strides) >= 2**31:
        raise ValueError(f"{kernel}: indices or strides beyond 2^31 (B*Nq*side = {b * nq * side})")
    nl = len(volumes)
    n = b * nq * side * side
    step = -(-n // (16 // volumes[0].element_size())) * (16 // volumes[0].element_size())
    buf = torch.empty(nl * step, dtype=volumes[0].dtype, device=volumes[0].device)
    outs = [buf[l * step: l * step + n].view(b, nq, side, side) for l in range(nl)]

    def arr(ctype, values):
        return (ctype * nl)(*values)

    fn = _volume_patch_lib()
    with torch.cuda.device(volumes[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            volumes[0].element_size(), nl,
            arr(ctypes.c_void_p, [v.data_ptr() for v in volumes]),
            arr(ctypes.c_void_p, [r.data_ptr() for r in rrs]),
            arr(ctypes.c_void_p, [c.data_ptr() for c in ccs]),
            arr(ctypes.c_void_p, [o.data_ptr() for o in outs]),
            arr(ctypes.c_int, [lh for lh, _ in dims]), arr(ctypes.c_int, [lw for _, lw in dims]),
            *(arr(ctypes.c_longlong, [st[k] for st in strides]) for k in range(3)),
            (ctypes.c_longlong * (4 * nl))(*(t.numel() for group in zip(volumes, rrs, ccs, outs)
                                             for t in group)),
            b * nq, nq, side, stream,
        )
    check_launch(rc, kernel)
    return outs


def dense_patch_level_plain(volume: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one gather per query from its own plane."""
    b, nq, side = rr.shape
    n, lh, lw = volume.shape
    idx = rr.long()[:, :, :, None] * lw + cc.long()[:, :, None, :]
    patch = torch.gather(volume.reshape(n, lh * lw), 1, idx.reshape(n, side * side))
    return patch.reshape(b, nq, side, side)


def dense_patch_levels_plain(volumes: Sequence[torch.Tensor], rrs: Sequence[torch.Tensor],
                             ccs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain PyTorch version of dense_patch_levels: level by level."""
    return [dense_patch_level_plain(v, rr, cc) for v, rr, cc in zip(volumes, rrs, ccs)]


@refuses_gradient
def dense_patch_levels(volumes: Sequence[torch.Tensor], rrs: Sequence[torch.Tensor],
                       ccs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every level of one lookup: volumes [B*Nq, lh, lw] (bf16 or f32) +
    per level clamped rr, cc [B, Nq, side] int32 -> per level a patch
    [B, Nq, side, side] of exact volume entries.  CPU tensors: the plain
    version; CUDA tensors: the kernel, one launch for all levels (counted as
    kernels.dense_patch_level.launches)."""
    check_volume_levels(volumes, rrs, ccs, "flat")
    dev = volumes[0].device
    if dev.type == "cpu":
        return dense_patch_levels_plain(volumes, rrs, ccs)
    if dev.type != "cuda":
        raise ValueError(f"dense_patch_level runs on cpu or cuda, not {dev}")
    outs = launch_volume_patch(volumes, rrs, ccs, "flat", "dense_patch_level")
    count_launch(dense_patch_level)
    return outs


def dense_patch_level(volume: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """One level: volume [B*Nq, lh, lw] (bf16 or f32) + clamped rr, cc
    [B, Nq, side] int32 -> patch [B, Nq, side, side] of exact volume
    entries, through dense_patch_levels."""
    return dense_patch_levels([volume], [rr], [cc])[0]
