"""K8: one 1x1 convolution of PCBlock4 (core/sk.py) as a GEMM on NHWC
tensors as they are stored, csrc/pointwise_gemm.cu.  It replaces no TPU
kernel: the JAX package left these convolutions to XLA.

For x [..., K] (its tokens' rows evenly strided, the last axis unit
strided), the conv's weight [N, K, 1, 1] (or [N, K]), its bias [N] and an
optional residual [..., N]:

    y = act(residual + (bias + x W^T))        [..., N], contiguous

act is the identity or core/encoders.gelu (tanh form in bf16, erf in f32),
evaluated on the f32 sum; sums in f32, one rounding to x's dtype.

`pointwise_gemm` launches the kernel for CUDA tensors and runs
`pointwise_gemm_plain` for CPU tensors; like every kernel entry it refuses a
gradient.  `pointwise_stage`, which PCBlock4 calls, is the same with a
backward: the plain twin recomputed (`_nograd.recomputes_gradient`), since
the JAX package differentiates these convolutions through XLA's own.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, library
from ._nograd import recomputes_gradient, refuses_gradient

# The kernel's tile widths (csrc/pointwise_gemm.cu: one wgmma shape each).
TILE_WIDTHS = (8,) + tuple(range(16, 129, 16))
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def tile_width(n: int) -> int:
    """The kernel's tile width for N outputs: the fewest tiles of at most
    128 columns that cover N, each rounded up to a width the kernel has."""
    tiles = -(-n // TILE_WIDTHS[-1])
    per = -(-n // tiles)
    return next(w for w in TILE_WIDTHS if w >= per)


def pointwise_gemm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None, act: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, in f32 with one rounding to x's dtype, on x
    in whatever memory layout it has (`pointwise_stage` runs it so on CPU
    tensors, and differentiates it on every device).  NHWC x goes through
    the module's former composition on NCHW views (F.conv2d, the add, the
    GELU), so that f32 tensors give its values bit for bit."""
    n, k = weight.shape[0], weight.shape[1]
    if x.dim() == 4:
        y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.reshape(n, k, 1, 1).float(), bias.float())
        if residual is not None:
            y = residual.float().permute(0, 3, 1, 2) + y
    else:
        y = F.linear(x.float(), weight.reshape(n, k).float(), bias.float())
        if residual is not None:
            y = residual.float() + y
    if act:
        y = F.gelu(y, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    y = y.to(x.dtype)
    return y.permute(0, 2, 3, 1) if x.dim() == 4 else y


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between t's rows (its last axis unit strided, the leading
    axes one evenly strided run of rows), or None."""
    if t.dim() < 1 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    sizes, strides = t.shape[:-1], t.stride()[:-1]
    dims = [(s, st) for s, st in zip(sizes, strides) if s != 1]
    if not dims:
        return t.shape[-1]
    for (_, outer), (size, inner) in zip(dims, dims[1:]):
        if outer != inner * size:
            return None
    return dims[-1][1] if dims[-1][1] >= t.shape[-1] else None


def _check(x, weight, bias, residual, rows: bool = True) -> Tuple[int, int, Optional[int], Optional[int]]:
    """(K, N, x's row stride, the residual's) after the checks both devices
    make; `rows`: x and the residual must lie as evenly strided rows (the
    kernel's layout), else the strides are None.  Plain comparisons: the
    checks run on every launch, 360 a frame."""
    name = "pointwise_gemm"
    if x.dim() < 2:
        raise ValueError(f"{name}: x must be [..., K] with tokens before the channels: {tuple(x.shape)}")
    k, ws = x.shape[-1], weight.shape
    if not (len(ws) in (2, 4) and ws[1] == k and ws[2:] in ((), (1, 1))):
        raise ValueError(f"{name}: weight must be [N, {k}, 1, 1] or [N, {k}]: {tuple(ws)}")
    n = ws[0]
    if bias is None or bias.shape != (n,):
        raise ValueError(f"{name}: bias must be [{n}]: {None if bias is None else tuple(bias.shape)}")
    if residual is not None and residual.shape != x.shape[:-1] + (n,):
        raise ValueError(f"{name}: residual must be {tuple(x.shape[:-1]) + (n,)}: {tuple(residual.shape)}")
    dtype, device = x.dtype, x.device
    if dtype not in _DTYPE_CODES or weight.dtype != dtype or bias.dtype != dtype or (
            residual is not None and residual.dtype != dtype):
        raise ValueError(f"{name}: x, the weights and the residual must share bfloat16 or float32: "
                         f"{[t.dtype for t in (x, weight, bias, residual) if t is not None]}")
    if weight.device != device or bias.device != device or (residual is not None and residual.device != device):
        raise ValueError(f"{name}: tensors on different devices: "
                         f"{[str(t.device) for t in (x, weight, bias, residual) if t is not None]}")
    if k < 1 or n < 1:
        raise ValueError(f"{name}: K = {k} and N = {n} must be positive")
    if not rows:
        return k, n, None, None
    strides = [None if t is None else _row_stride(t) for t in (x, residual)]
    for what, t, ld in (("x", x, strides[0]), ("residual", residual, strides[1])):
        if t is not None and ld is None:
            raise ValueError(f"{name}: {what} must lie as evenly strided rows with a unit-strided "
                             f"last axis: {tuple(t.shape)}, strides {t.stride()}")
    return k, n, strides[0], strides[1]


def _lib():
    fn = library("pointwise_gemm").tf_pointwise_gemm
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _copy_vector(ld: int, t: torch.Tensor, width: int = 8) -> int:
    """Elements per copy into shared memory of t's rows, `ld` elements apart:
    16 bytes where the row stride, the address and `width` (a row's
    elements, where the copies must not straddle its end) allow, else 8, 4
    or 2 bytes (the kernel's rule)."""
    for vec in (8, 4, 2):
        if ld % vec == 0 and width % vec == 0 and t.data_ptr() % (vec * t.element_size()) == 0:
            return vec
    return 1


def _padded(n: int) -> int:
    """A row stride of n elements rounded up to 16 bytes of bf16."""
    return -(-n // 8) * 8


# id(weight) -> (a weak reference to it, its version, its padded rows); an
# entry goes with its weight.
_PADDED_WEIGHTS: dict = {}


def _weight_rows(weight: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The conv's weight as [N, K] rows that 16-byte copies can start: the
    weight itself where K is a multiple of 8, else a copy with rows padded
    to 16 bytes, kept beside the parameter until it changes (its version
    counter; the copy is 2 N K bytes, made once per weight; an inference
    tensor has no counter and is copied for each launch)."""
    if weight.dtype != torch.bfloat16 or k % 8 == 0:
        return weight.reshape(n, k).contiguous()
    if weight.is_inference():          # no version counter to trust: copied for each launch
        padded = torch.zeros((n, _padded(k)), dtype=weight.dtype, device=weight.device)
        padded[:, :k] = weight.reshape(n, k)
        return padded[:, :k]
    ref, version, rows = _PADDED_WEIGHTS.get(id(weight), (None, None, None))
    if ref is None or ref() is not weight or version != weight._version:
        padded = torch.zeros((n, _padded(k)), dtype=weight.dtype, device=weight.device)
        padded[:, :k] = weight.detach().reshape(n, k)
        if ref is None or ref() is not weight:
            weakref.finalize(weight, _PADDED_WEIGHTS.pop, id(weight), None)
        rows = padded[:, :k]
        _PADDED_WEIGHTS[id(weight)] = (weakref.ref(weight), weight._version, rows)
    return rows


@refuses_gradient
def pointwise_gemm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None, *, act: bool = False, pad: bool = False,
) -> torch.Tensor:
    """act(residual + (bias + x W^T)) for x [..., K] lying as evenly strided
    rows (a unit-strided last axis), a 1x1 conv's weight [N, K, 1, 1] (or
    [N, K]) and bias [N], and an optional residual [..., N] laid out as x
    is, all of x's dtype (bf16 or f32); act: GELU (core/encoders.gelu) or
    none.  Returns a new [..., N] tensor (never one of the inputs),
    contiguous, or with pad on a CUDA tensor the first N columns of rows
    padded to 16 bytes, which the next launch reads in 16-byte pieces (the
    FFN's middle tensor).  CPU tensors: the plain version; CUDA tensors:
    the kernel."""
    k, n, lda, ldr = _check(x, weight, bias, residual)
    if x.device.type == "cpu":
        return pointwise_gemm_plain(x, weight, bias, residual, act).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"pointwise_gemm runs on cpu or cuda, not {x.device}")
    ldy = _padded(n) if pad else n
    out = torch.empty(tuple(x.shape[:-1]) + (ldy,), dtype=x.dtype, device=x.device)[..., :n]
    m = out.numel() // n
    if m == 0:
        return out
    w, bias = _weight_rows(weight, n, k), bias.contiguous()
    ldw, ldr = w.stride(0), ldr or 0
    res_vec = 1 if residual is None else _copy_vector(ldr, residual, n)
    # Each tensor's span in elements from its first one (bounds guards).
    spans = ((m - 1) * lda + k, (n - 1) * ldw + k, n, 0 if residual is None else (m - 1) * ldr + n,
             (m - 1) * ldy + n)
    extents = (ctypes.c_longlong * 5)(*spans)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODES[x.dtype], x.data_ptr(), lda, w.data_ptr(), ldw, bias.data_ptr(),
            None if residual is None else residual.data_ptr(), ldr, out.data_ptr(), ldy, m, k, n, int(act),
            _copy_vector(lda, x), _copy_vector(ldw, w), tile_width(n), res_vec, extents, stream,
        )
    check_launch(rc, "pointwise_gemm")
    count_launch(pointwise_gemm)
    return out


def pointwise_stage(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None, *, act: bool = False, pad: bool = False,
) -> torch.Tensor:
    """`pointwise_gemm` on x and a residual in any memory layout, with a
    backward through `pointwise_gemm_plain`: on CUDA tensors the kernel,
    whatever the grad mode (rows that are not evenly strided are made
    contiguous first); on CPU tensors the twin on x as it lies.  Raises on
    what the kernel refuses, on both devices."""
    if x.device.type == "cpu":
        _check(x, weight, bias, residual, rows=False)

    def kernel(x, weight, bias, residual):
        rows = [t if t is None or _row_stride(t) is not None else t.contiguous() for t in (x, residual)]
        return pointwise_gemm(rows[0], weight, bias, rows[1], act=act, pad=pad)

    return recomputes_gradient(
        kernel, lambda *tensors: pointwise_gemm_plain(*tensors, act), x, weight, bias, residual,
    )
