"""K7: one stage of PCBlock4's conv_list (core/sk.py) in one launch,
csrc/depthwise.cu.  It replaces no TPU kernel: the JAX package left these
convolutions to XLA.

For NHWC x [B, Hin, W, C], a depthwise k x k weight [C, 1, k, k] (k one of
KERNEL_SIZES, PCBlock4's), a bias [C] and row pads (top, bottom), each at
most k // 2:

    y = act(x1 + (b + dwconv_k(x1)))        [B, Hin + top + bottom - (k - 1), W, C]

with the width padded 'SAME' (k // 2 a side) and the rows by (top, bottom),
zeros outside x.  x1 is x, or, with the weights of a pointwise (k = 1)
entry before it (`pre_weight` [C, 1, 1, 1], `pre_bias` [C]), that entry's
output act(x + (pb + pw x)), rounded to x's dtype: the zero padding applies
to x1.  act is core/encoders.gelu (tanh form in bf16, erf in f32).  Sums in
f32, one rounding to x's dtype.  A whole frame takes pads (k // 2, k // 2);
a strip of a spatially sharded frame passes the rows it fetched and the
pads at the frame's edges (core/strips.depthwise_rows).

`depthwise_residual_gelu` launches the kernel for CUDA tensors and runs
`depthwise_residual_gelu_plain` for CPU tensors; like every kernel entry it
refuses a gradient.  `depthwise_stage`, which PCBlock4 calls, is the same
with a backward: the plain twin recomputed (`_nograd.recomputes_gradient`),
since the JAX package differentiates these convolutions through XLA's own.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, library
from ._nograd import recomputes_gradient, refuses_gradient

KERNEL_SIZES = (1, 7, 15)   # the kernel's templates (csrc/depthwise.cu)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def _act(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """core/encoders.gelu's form for `dtype`, evaluated on f32 v."""
    return F.gelu(v, approximate="tanh" if dtype == torch.bfloat16 else "none")


def depthwise_residual_gelu_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    pre_weight: Optional[torch.Tensor] = None, pre_bias: Optional[torch.Tensor] = None,
    pads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain PyTorch version, in f32 with one rounding to x's dtype (the
    prologue's output rounded once too), on NCHW views of x in whatever
    memory layout x has: on f32 tensors with the default pads it makes the
    module's former calls (`depthwise_stage` runs it so on CPU tensors, and
    differentiates it on every device).  Returns an NHWC view."""
    k = weight.shape[-1]
    top, bottom = (k // 2, k // 2) if pads is None else pads
    xc = x.permute(0, 3, 1, 2).float()
    if pre_weight is not None:
        xc = depthwise_residual_gelu_plain(x, pre_weight, pre_bias).permute(0, 3, 1, 2).float()
    wf, bf = weight.float(), bias.float()
    if top == bottom == k // 2:
        y = F.conv2d(xc, wf, bf, padding=k // 2, groups=x.shape[-1])
    else:
        y = F.conv2d(F.pad(xc, (k // 2, k // 2, top, bottom)), wf, bf, groups=x.shape[-1])
    res = xc[:, :, k // 2 - top : k // 2 - top + y.shape[2]]
    return _act(res + y, x.dtype).to(x.dtype).permute(0, 2, 3, 1)


def _check(x, weight, bias, pre_weight, pre_bias, pads, contiguous: bool = True) -> Tuple[int, int]:
    name = "depthwise_residual_gelu"
    if x.dim() != 4 or (contiguous and not x.is_contiguous()):
        raise ValueError(f"{name}: x must be a contiguous NHWC [B, H, W, C] tensor: "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    c = x.shape[3]
    k = weight.shape[-1] if weight.dim() == 4 else -1
    if weight.dim() != 4 or tuple(weight.shape) != (c, 1, k, k) or k not in KERNEL_SIZES:
        raise ValueError(f"{name}: weight must be [{c}, 1, k, k] with k in {KERNEL_SIZES}: "
                         f"{tuple(weight.shape)}")
    if (pre_weight is None) != (pre_bias is None):
        raise ValueError(f"{name}: pre_weight and pre_bias go together")
    if pre_weight is not None and tuple(pre_weight.shape) != (c, 1, 1, 1):
        raise ValueError(f"{name}: pre_weight must be [{c}, 1, 1, 1]: {tuple(pre_weight.shape)}")
    if bias is None or any(t is not None and tuple(t.shape) != (c,) for t in (bias, pre_bias)):
        raise ValueError(f"{name}: bias (and pre_bias) must be [{c}]")
    tensors = [t for t in (x, weight, bias, pre_weight, pre_bias) if t is not None]
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{name}: x and the weights must share bfloat16 or float32: "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices: {[str(t.device) for t in tensors]}")
    top, bottom = (k // 2, k // 2) if pads is None else pads
    if not (0 <= top <= k // 2 and 0 <= bottom <= k // 2) or x.shape[1] + top + bottom - (k - 1) < 1:
        raise ValueError(f"{name}: row pads {pads} for k = {k} and {x.shape[1]} rows: each pad "
                         f"within 0..{k // 2}, at least one output row")
    return top, bottom


def _lib():
    fn = library("depthwise").tf_depthwise_residual_gelu
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _staging_vector(x: torch.Tensor) -> int:
    """Elements per staging load of x: 16 bytes where its channel count and
    address allow, else 8 bytes, else one element (the kernel's rule)."""
    e = 16 // x.element_size()
    for vec in (e, e // 2):
        if x.shape[3] % vec == 0 and x.data_ptr() % (vec * x.element_size()) == 0:
            return vec
    return 1


@refuses_gradient
def depthwise_residual_gelu(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    pre_weight: Optional[torch.Tensor] = None, pre_bias: Optional[torch.Tensor] = None,
    *, pads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """act(x1 + (b + dwconv_k(x1))) for contiguous NHWC x [B, H, W, C], a
    depthwise weight [C, 1, k, k] (k in KERNEL_SIZES) and bias [C] of x's
    dtype (bf16 or f32); x1 = x, or the folded pointwise entry's output
    (pre_weight [C, 1, 1, 1] and pre_bias [C]).  A model that needs another
    k or no bias meets the ValueError on both devices.
    pads: the rows' (top, bottom) zero padding (None: k // 2 each).  CPU
    tensors: the plain version; CUDA tensors: the kernel."""
    top, bottom = _check(x, weight, bias, pre_weight, pre_bias, pads)
    if x.device.type == "cpu":
        return depthwise_residual_gelu_plain(x, weight, bias, pre_weight, pre_bias, (top, bottom)).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_residual_gelu runs on cpu or cuda, not {x.device}")
    weight, bias = weight.contiguous(), bias.contiguous()
    if pre_weight is not None:
        pre_weight, pre_bias = pre_weight.contiguous(), pre_bias.contiguous()
    b, h, w, c = x.shape
    k = weight.shape[-1]
    out = torch.empty((b, h + top + bottom - (k - 1), w, c), dtype=x.dtype, device=x.device)
    args = (x, weight, bias, pre_weight, pre_bias, out)
    extents = (ctypes.c_longlong * 6)(*(0 if t is None else t.numel() for t in args))
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODES[x.dtype], *(None if t is None else t.data_ptr() for t in args),
            b, h, w, c, k, top, bottom, _staging_vector(x), extents, stream,
        )
    check_launch(rc, "depthwise_residual_gelu")
    count_launch(depthwise_residual_gelu)
    return out


def depthwise_stage(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    pre_weight: Optional[torch.Tensor] = None, pre_bias: Optional[torch.Tensor] = None,
    *, pads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """`depthwise_residual_gelu` on NHWC x in any memory layout, with a
    backward through `depthwise_residual_gelu_plain`: on CUDA tensors the
    kernel, whatever the grad mode; on CPU tensors the twin on x as it lies,
    so that f32 tensors with the default pads make the module's former
    calls.  Raises on what the kernel refuses, on both devices."""
    if x.device.type == "cpu":
        _check(x, weight, bias, pre_weight, pre_bias, pads, contiguous=False)
    return recomputes_gradient(
        lambda x, *params: depthwise_residual_gelu(x.contiguous(), *params, pads=pads),
        lambda *tensors: depthwise_residual_gelu_plain(*tensors, pads),
        x, weight, bias, pre_weight, pre_bias,
    )
