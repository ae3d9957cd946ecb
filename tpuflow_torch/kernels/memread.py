"""K9: MemFlow's memory reader (core/memflownet.py MemoryReader) in one
launch, csrc/memory_read.cu.  It replaces no TPU kernel: the JAX reader
(tpuflow/core/memflownet.py, MemoryReader) is XLA einsums.

For query q [B, hw, dk], the memory's keys [B, cap, hw, dk], values
[B, cap, hw, dv] and valid [B, cap], and an optional RoPE table
[hw, 2, dk / 2] (`rope_table`):

    read[b, i] = softmax over the valid slots' tokens (s, j) of
                 rope(q[b, i] / sqrt(dk)) . rope(k[b, s, j]), applied to v[b, s, j]

in f32, [B, hw, dv]; a batch row with no valid slot reads zeros.

`memory_read` launches the kernel for CUDA tensors and runs
`memory_read_plain` for CPU tensors; like every kernel entry it refuses a
gradient.  `memory_read_stage`, which MemoryReader calls, is the same with a
backward: the plain twin recomputed (`_nograd.recomputes_gradient`), since
the JAX package differentiates its reader through XLA's own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import check_launch, count_launch, library
from ._nograd import recomputes_gradient, refuses_gradient

KEY_DIM, VALUE_DIM = 64, 128      # the kernel's build (csrc/memory_read.cu)
_QUERY_CODES = {torch.bfloat16: 0, torch.float32: 1}
_CHUNK = 2048                      # query rows of one score strip in the plain version


def rope_table(h: int, w: int, d: int, device=None) -> torch.Tensor:
    """The cos and sin of 2D rotary positions over an h x w grid for d
    channels, [h*w, 2, d/2] f32: pair p < d/4 turns with the x coordinate,
    pair d/4 + p with y, both by pos * 10000^(-p / (d/4)) (core/memflownet
    rope_2d's angles, from the same operations)."""
    if d % 4:
        raise ValueError(f"rope_2d needs a channel count divisible by 4, got {d}")
    half = d // 4
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = [pos.reshape(-1)[:, None] * freqs[None, :] for pos in (xs, ys)]      # [hw, half] each
    return torch.stack([torch.cat([torch.cos(a) for a in ang], -1),
                        torch.cat([torch.sin(a) for a in ang], -1)], dim=1)


def rope_rotate(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """t [..., hw, d] rotated by `table` [hw, 2, d/2] in f32, cast back to
    t's dtype: within each half of the channels, channel i of the first
    quarter pairs with channel i of the second."""
    d = t.shape[-1]
    dh, half = d // 2, d // 4
    cos, sin = table[:, 0], table[:, 1]
    x1 = torch.cat([t[..., :half], t[..., dh : dh + half]], -1).float()
    x2 = torch.cat([t[..., half:dh], t[..., dh + half :]], -1).float()
    r1, r2 = x1 * cos - x2 * sin, x1 * sin + x2 * cos
    return torch.cat([r1[..., :half], r2[..., :half], r1[..., half:], r2[..., half:]], -1).to(t.dtype)


def memory_read_plain(
    q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version, in f32: q scaled by dk^-1/2, q and the keys
    rotated by `table` (if given), scores of invalid slots -1e9 before the
    softmax, `_CHUNK` query rows at a time, so that the scores are
    [chunk, cap*hw] a step; a batch row with no valid slot reads zeros."""
    b, hw, dk = q.shape
    cap, dv = valid.shape[1], values.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(dk))
    k = keys.float()
    if table is not None:
        qf, k = rope_rotate(qf, table), rope_rotate(k, table)
    k = k.reshape(b, cap * hw, dk)
    v = values.reshape(b, cap * hw, dv).float()
    invalid = (valid <= 0).repeat_interleave(hw, dim=1)          # [B, cap*hw]
    read = torch.empty((b, hw, dv), dtype=torch.float32, device=q.device)
    for i in range(b):
        kt = k[i].t()
        for c0 in range(0, hw, _CHUNK):
            sim = torch.matmul(qf[i, c0 : c0 + _CHUNK], kt)
            sim.masked_fill_(invalid[i], -1e9)
            read[i, c0 : c0 + _CHUNK] = torch.matmul(torch.softmax(sim, dim=-1), v[i])
            del sim
    any_valid = (valid.sum(dim=1) > 0)[:, None, None]
    return torch.where(any_valid, read, torch.zeros((), device=read.device))


def _check(q, keys, values, valid, table, kernel: bool) -> None:
    """The shapes both devices need; `kernel`: also what the kernel takes
    (its dk and dv, dtypes, contiguity, alignment, one device)."""
    name = "memory_read"
    if q.dim() != 3 or keys.dim() != 4 or values.dim() != 4 or valid.dim() != 2:
        raise ValueError(f"{name}: q [B, hw, dk], keys [B, cap, hw, dk], values [B, cap, hw, dv] and "
                         f"valid [B, cap]: {[tuple(t.shape) for t in (q, keys, values, valid)]}")
    b, hw, dk = q.shape
    cap, dv = valid.shape[1], values.shape[-1]
    if (tuple(keys.shape) != (b, cap, hw, dk) or tuple(values.shape) != (b, cap, hw, dv)
            or valid.shape[0] != b):
        raise ValueError(f"{name}: keys must be {(b, cap, hw, dk)} and values {(b, cap, hw, 'dv')} for "
                         f"q {tuple(q.shape)} and valid {tuple(valid.shape)}: {tuple(keys.shape)}, "
                         f"{tuple(values.shape)}")
    if table is not None and (dk % 4 or tuple(table.shape) != (hw, 2, dk // 2)):
        raise ValueError(f"{name}: rotary positions need dk divisible by 4 and a table [{hw}, 2, {dk // 2}]: "
                         f"dk {dk}, table {tuple(table.shape)}")
    if not kernel:
        return
    if dk != KEY_DIM or dv != VALUE_DIM:
        raise ValueError(f"{name}: the kernel is built for dk {KEY_DIM} and dv {VALUE_DIM}: {dk}, {dv}")
    if q.dtype not in _QUERY_CODES or any(t.dtype != torch.float32 for t in (keys, values, valid)) or (
            table is not None and table.dtype != torch.float32):
        raise ValueError(f"{name}: q bfloat16 or float32, keys, values, valid and the table float32: "
                         f"{[t.dtype for t in (q, keys, values, valid, table) if t is not None]}")
    tensors = [t for t in (q, keys, values, valid, table) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices: {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: q, keys, values, valid and the table must be contiguous: "
                         f"{[t.stride() for t in tensors]}")
    if any(t.data_ptr() % 16 for t in (keys, values, table) if t is not None):
        raise ValueError(f"{name}: keys, values and the table must start on 16 bytes (cp.async)")


def _lib():
    fn = library("memory_read").tf_memory_read
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


@refuses_gradient
def memory_read(
    q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The readout [B, hw, dv] f32 of q [B, hw, dk] over the memory's keys
    [B, cap, hw, dk], values [B, cap, hw, dv] and valid [B, cap], rotated by
    `table` [hw, 2, dk/2] (rope_table) if given.  CPU tensors: the plain
    version; CUDA tensors: the kernel (dk 64, dv 128; q bf16 or f32, the
    rest f32, all contiguous), or a ValueError."""
    on_cpu = q.device.type == "cpu"
    _check(q, keys, values, valid, table, kernel=not on_cpu)
    if on_cpu:
        return memory_read_plain(q, keys, values, valid, table)
    if q.device.type != "cuda":
        raise ValueError(f"memory_read runs on cpu or cuda, not {q.device}")
    b, hw, dk = q.shape
    cap, dv = valid.shape[1], values.shape[-1]
    out = torch.empty((b, hw, dv), dtype=torch.float32, device=q.device)
    args = (q, keys, values, valid, table, out)
    extents = (ctypes.c_longlong * 6)(*(0 if t is None else t.numel() for t in args))
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_QUERY_CODES[q.dtype], *(None if t is None else t.data_ptr() for t in args),
                b, cap, hw, dk, dv, 1.0 / math.sqrt(dk), extents, stream)
    check_launch(rc, "memory_read")
    count_launch(memory_read)
    return out


def memory_read_stage(
    q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`memory_read` with a backward through `memory_read_plain`: on CUDA
    tensors the kernel, whatever the grad mode; on CPU tensors the twin.
    Raises on what the kernel refuses."""
    return recomputes_gradient(memory_read, memory_read_plain, q, keys, values, valid, table)
