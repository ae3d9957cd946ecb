"""K1: fused dense radius lookup (port of `dense_feature_level`,
tpuflow/kernels/denselookup.py:398).

For every query of a materialized correlation pyramid (levels [N, lh, lw],
N = B*h*w, bf16 or f32) and its current flow [B, h, w, 2], sample the
(2r+1)^2 window around the flow target at every level with zero borders
and the two-stage f32 bilinear of the fused TPU kernel, in the upstream
x-major channel order (c = lvl*(2r+1)^2 + col*(2r+1) + row).

`dense_lookup` launches csrc/dense_lookup.cu for CUDA tensors and runs
`dense_lookup_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import check_launch, library

MAX_LEVELS = 8
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def dense_lookup_plain(
    volumes: Sequence[torch.Tensor], flow: torch.Tensor, radius: int
) -> torch.Tensor:
    """Plain PyTorch version: a gather of each query's (2r+2)^2 patch, zeros
    outside the plane, then the f32 bilinear in the kernel's order."""
    b, h, w, _ = flow.shape
    n = b * h * w
    side = 2 * radius + 2
    ns = side - 1
    dev = flow.device
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32),
        indexing="ij",
    )
    base_x = (xs[None] + flow[..., 0]).reshape(n)
    base_y = (ys[None] + flow[..., 1]).reshape(n)
    offs = torch.arange(side, device=dev)
    out = []
    for lvl, vol in enumerate(volumes):
        lh, lw = vol.shape[1], vol.shape[2]
        cx = base_x / (2.0**lvl)
        cy = base_y / (2.0**lvl)
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
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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


def dense_lookup(
    volumes: Sequence[torch.Tensor], flow: torch.Tensor, radius: int
) -> torch.Tensor:
    """[N, lh, lw] levels + flow [B, h, w, 2] f32 -> [B, h, w, L*(2r+1)^2]
    f32.  CPU tensors: the plain version; CUDA tensors: the kernel, one
    launch for all levels."""
    _check(volumes, flow)
    if flow.device.type == "cpu":
        return dense_lookup_plain(volumes, flow, radius)
    if flow.device.type != "cuda":
        raise ValueError(f"dense_lookup runs on cpu or cuda, not {flow.device}")
    b, h, w, _ = flow.shape
    nl = len(volumes)
    ncs = (2 * radius + 1) ** 2
    out = torch.empty((b, h, w, nl * ncs), dtype=torch.float32, device=flow.device)
    ptrs = (ctypes.c_void_p * nl)(*[v.data_ptr() for v in volumes])
    lhs = (ctypes.c_int * nl)(*[v.shape[1] for v in volumes])
    lws = (ctypes.c_int * nl)(*[v.shape[2] for v in volumes])
    fn = _lib()
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODES[volumes[0].dtype], ptrs, lhs, lws, nl,
            flow.data_ptr(), out.data_ptr(), b * h * w, h, w, radius, stream,
        )
    check_launch(rc, "dense_lookup")
    dense_lookup.launches += 1
    return out


dense_lookup.launches = 0
