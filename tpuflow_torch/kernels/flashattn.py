"""K2: single-head flash attention forward for GMA aggregation (port of
`flash_aggregate`, tpuflow/core/gma.py:35, which runs the Pallas TPU
flash-attention kernel with sm_scale=1).

out = softmax(q k^T) v for q, k, v [B, S, 128] (q pre-scaled), softmax in
f32, output in v's dtype.  `flash_attention_fwd` launches
csrc/flash_attention.cu for CUDA tensors (bf16: tensor-core kernel; f32:
plain FMA kernel) and runs `flash_attention_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, library

HEAD_DIM = 128
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, budget: int = 3 * 10**8
) -> torch.Tensor:
    """Plain PyTorch version: the chunked exact softmax of Aggregate's 'xla'
    branch (gma.py:195-215) — [B, chunk, S] f32 score strips of at most
    `budget` bytes, probabilities cast to v's dtype for the product."""
    b, s, _ = q.shape
    chunk = max(1, min(2048, budget // max(1, b * s * 4)))
    kf = k.float()
    out = torch.empty_like(v)
    for i in range(0, s, chunk):
        sim = torch.matmul(q[:, i : i + chunk].float(), kf.transpose(1, 2))
        probs = torch.softmax(sim, dim=-1)
        out[:, i : i + chunk] = torch.matmul(probs.to(v.dtype), v)
    return out


def _lib():
    fn = library("flash_attention").tf_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v for [B, S, 128] tensors of one dtype (bf16 or f32).
    CPU tensors: the plain version; CUDA tensors: the kernel."""
    if q.dim() != 3 or q.shape[-1] != HEAD_DIM or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share shape [B, S, {HEAD_DIM}]: "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or v.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must be one of bf16/f32: {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device} {k.device} {v.device}")
    if v.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if v.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cpu or cuda, not {v.device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    b, s, _ = q.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    out = torch.empty_like(v)
    extents = (ctypes.c_longlong * 4)(*(t.numel() for t in (q, k, v, out)))
    fn = _lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODES[v.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, extents, stream,
        )
    check_launch(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
