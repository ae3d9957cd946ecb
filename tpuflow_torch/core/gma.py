"""GMA global motion aggregation (port of tpuflow/core/gma.py).

The context attention's q/k are computed once per window (`Attention`) and
re-applied to the motion features on every refinement iteration
(`Aggregate`), whose softmax(q k^T) v is kernel K2
(kernels/flashattn.py), or with `impl='xla'` the chunked exact softmax in
plain torch, which is differentiable.  Where the probabilities fit memory,
MemFlow, and MOFNet with gma_impl='xla', compute them once
(`materialize_attention`) and each iteration is then one matrix product.
Layout: NHWC at the public functions.

In a spatially sharded call (core/strips.py) a strip's queries attend to
the whole frame's keys: MOFNet.refine gathers k once per window, and
`Aggregate` gathers v on every iteration.

State-dict names follow upstream: att.to_qk.weight,
update_block.aggregator.to_v.weight, update_block.aggregator.gamma.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.flashattn import flash_attention_fwd, flash_attention_plain
from . import strips

GMA_IMPLS = ("auto", "flash", "xla")


def conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv applied to NHWC features as the linear map it is."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _pick_chunk(hw: int, max_chunk: int = 2048) -> int:
    """Largest divisor of hw that is <= max_chunk."""
    c = min(hw, max_chunk)
    while hw % c:
        c -= 1
    return c


def _row_chunk(b: int, hq: int, hk: int, budget: int = 3 * 10**8) -> int:
    """Query-row chunk (a divisor of hq) for [b, chunk, hk] f32 score
    strips of at most `budget` bytes."""
    return _pick_chunk(hq, max(1, min(2048, budget // max(1, b * hk * 4))))


def materialize_attention(q: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T) once per frame: q [B, h, w, d], k [B, hk, w, d] (hk =
    h but in a strip, whose queries meet the frame's keys) -> [B, hw, hk w]
    in `out_dtype`, the scores and softmax in f32 over `_row_chunk` query
    rows (tpuflow/core/gma.py:129)."""
    b, h, w, d = q.shape
    hw = h * w
    qf = q.reshape(b, hw, d).float()
    kt = k.reshape(b, -1, d).float().transpose(1, 2)
    chunk = _row_chunk(b, hw, kt.shape[2])
    out = torch.empty((b, hw, kt.shape[2]), dtype=out_dtype, device=q.device)
    for i in range(0, hw, chunk):
        out[:, i : i + chunk] = torch.softmax(torch.matmul(qf[:, i : i + chunk], kt), dim=-1)
    return out


class Attention(nn.Module):
    """Content-only GMA attention (heads=1): context [B, h, w, dim] ->
    (q * dim_head^-0.5, k), each [B, h, w, dim_head]."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.scale = dim_head ** -0.5
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, fmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q, k = conv1x1(fmap, self.to_qk).chunk(2, dim=-1)
        return q * self.scale, k


class Aggregate(nn.Module):
    """out = fmap + gamma * project(softmax(q k^T) v),  v = to_v(fmap), with
    v of the attention's head dim (the context dim).  VideoFlow's has dim ==
    dim_head (128) and no `project`; narrower contexts (dim_head != dim) get
    upstream's 1x1 output projection, as tpuflow/core/gma.py:227 does.

    `impl` (tpuflow/core/gma.py:167): how softmax(q k^T) v is applied when no
    materialized `attn` is given.  'auto' and 'flash' = kernel K2 (the flash
    kernel, as 'auto' means on the TPU; on the CPU its plain version), which
    refuses a gradient and takes a head dim of 128 only (the VideoFlow
    context); 'xla' = the chunked exact softmax in plain torch."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.impl = "auto"
        self.to_v = nn.Conv2d(dim, dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = nn.Conv2d(dim_head, dim, 1, bias=False) if dim_head != dim else None

    def forward(
        self, q: torch.Tensor, k: torch.Tensor, fmap: torch.Tensor, attn: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """With `attn` (materialize_attention's [B, hw, hw]) one product
        attn @ v in attn's dtype (the GEMM accumulates in f32), cast to
        fmap's dtype; without it kernel K2, or the chunked exact softmax
        for impl='xla'.  In a strip, k (and attn's keys) are the frame's,
        and v is gathered from every strip."""
        b, h, w, _ = fmap.shape
        v = conv1x1(fmap, self.to_v)
        d = v.shape[-1]
        strip = strips.current()
        keys = v if strip is None else strip.gather(v, 1)
        attend = flash_attention_plain if self.impl == "xla" else flash_attention_fwd
        if attn is not None:
            out = torch.matmul(attn, keys.reshape(b, -1, d).to(attn.dtype))
        else:
            out = attend(
                q.reshape(b, h * w, d).to(v.dtype).contiguous(),
                k.reshape(b, -1, d).to(v.dtype).contiguous(),
                keys.reshape(b, -1, d).contiguous(),
            )
        out = out.reshape(b, h, w, d).to(fmap.dtype)
        if self.project is not None:
            out = conv1x1(out, self.project)
        return fmap + self.gamma.to(fmap.dtype) * out
