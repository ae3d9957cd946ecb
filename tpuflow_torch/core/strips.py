"""Row strips of one frame: the context and the exchanges of spatial
sharding (runtime/sharding.py `shard_spatial_forward`).

A sharded call splits each frame's height into strips of whole feature rows
(8 pixel rows) and runs the model's own `forward` on every strip, one Python
thread per strip.  Inside those threads `current()` returns the thread's
`Strip`; everywhere else it returns None and every operation computes what
it computes unsharded.  The few operations that are not local in rows read
it:

- a convolution that reaches across rows (`conv_same`) fetches its halo;
  a depthwise stage of PCBlock4 fetches the rows inside the frame and
  passes the frame's own padding to its kernel (`depthwise_rows`);
- a norm's statistics are summed over the strips (`Strip.all_sum`);
- attention and correlation fetch the rows of every strip they read
  (`Strip.gather`, `Strip.fetch`);
- decisions that depend on the frame's size read its whole height
  (`global_rows`).

One primitive serves every exchange: each strip publishes its own rows of a
tensor, and `Strip.fetch(x, dim, start, stop)` assembles the frame's rows
[start, stop) from whichever strips hold them, moved to the caller's
device, with the operation's own zero padding for rows outside the frame.
A halo, a window that spans three strips and an all-gather are the same
call.  Every exchange is collective: all strips of a group make the same
calls in the same order, and a tag (the call's name and shape) checks it.
A tensor a strip has published is read by the others after the exchange,
so it must not be changed in place afterwards.

Rows are counted at each tensor's own resolution: a strip of n feature
rows holds 8n pixel rows, 2n rows of a 1/4 map and n of a 1/8 one.  One
strip's exception aborts the group's barrier, so that the others raise
instead of waiting.
"""

from __future__ import annotations

import threading
from contextvars import ContextVar
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_STRIP: ContextVar[Optional["Strip"]] = ContextVar("tpuflow_strip", default=None)


class StripGroup:
    """The strips of one frame (of one batch shard): `rows[i]` feature rows
    each, top to bottom, exchanging tensors through a barrier."""

    def __init__(self, rows: Sequence[int]):
        if not rows or min(rows) < 1:
            raise ValueError(f"every strip needs a feature row: {list(rows)}")
        self.rows = list(rows)
        self.starts = [sum(self.rows[:i]) for i in range(len(self.rows))]
        self.total = sum(self.rows)
        self._barrier = threading.Barrier(len(self.rows))
        # Two buffers: exchange g writes buffer g % 2, and a strip reaches
        # exchange g + 2 only after every strip has passed exchange g + 1's
        # barrier, that is, has read exchange g.
        self._slots: List[list] = [[None] * len(self.rows), [None] * len(self.rows)]
        self._calls = [0] * len(self.rows)
        # Bytes each strip took from the other strips' tensors.
        self.fetched_bytes = [0] * len(self.rows)

    def exchange(self, index: int, tag, value) -> list:
        """Publish `value` as strip `index`'s and return every strip's, in
        strip order, once all have published."""
        buf = self._slots[self._calls[index] % 2]
        self._calls[index] += 1
        buf[index] = (tag, value)
        self._barrier.wait()
        tags = [t for t, _ in buf]
        if any(t != tags[0] for t in tags):
            raise RuntimeError(f"strips out of step: {tags}")
        return [v for _, v in buf]

    def abort(self) -> None:
        """Break the barrier: every strip waiting or yet to wait raises
        threading.BrokenBarrierError."""
        self._barrier.abort()


class Strip:
    """Strip `index` of `group`.  Its exchanges return tensors on the device
    of the tensor it gives them."""

    def __init__(self, group: StripGroup, index: int):
        self.group, self.index = group, index

    def scale(self, local_rows: int) -> int:
        """Rows per feature row of a tensor that holds `local_rows` rows of
        this strip."""
        n = self.group.rows[self.index]
        if local_rows % n:
            raise ValueError(f"{local_rows} rows are not a whole number of this strip's {n} feature rows")
        return local_rows // n

    def span(self, local_rows: int) -> Tuple[int, int]:
        """This strip's rows [start, stop) in the frame, at the resolution of
        a tensor that holds `local_rows` of them."""
        s = self.scale(local_rows)
        start = s * self.group.starts[self.index]
        return start, start + local_rows

    def global_rows(self, local_rows: int) -> int:
        """The frame's rows at the resolution of a tensor that holds
        `local_rows` of this strip's."""
        return self.scale(local_rows) * self.group.total

    def fetch(self, x: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
        """The frame's rows [start, stop) of x along `dim` (x holds this
        strip's rows there), from every strip that holds them, on x's
        device; zeros for rows outside the frame.  Collective."""
        dim = dim % x.dim()
        shape = tuple(x.shape[:dim]) + tuple(x.shape[dim + 1:])
        parts = self.group.exchange(self.index, ("fetch", dim, shape, x.dtype), x)
        s = self.scale(x.shape[dim])
        pieces, row = [], start
        total = s * self.group.total

        def zeros(n):
            size = list(x.shape)
            size[dim] = n
            return torch.zeros(size, dtype=x.dtype, device=x.device)

        if row < 0:
            pieces.append(zeros(min(stop, 0) - row))
            row = min(stop, 0)
        for i, part in enumerate(parts):
            lo = s * self.group.starts[i]
            hi = lo + part.shape[dim]
            a, b = max(row, lo), min(stop, hi)
            if a >= b:
                continue
            piece = part.narrow(dim, a - lo, b - a)
            if i != self.index:
                self.group.fetched_bytes[self.index] += piece.numel() * piece.element_size()
            pieces.append(piece.to(x.device))
            row = b
        if row < stop:
            if row < total:
                raise AssertionError(f"rows {row}..{stop} of {total} were not fetched")
            pieces.append(zeros(stop - row))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every row of the frame along `dim`.  Collective."""
        return self.fetch(x, dim, 0, self.global_rows(x.shape[dim]))

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every strip's x, in strip order, on x's device: the
        same value on every strip.  Collective."""
        parts = self.group.exchange(self.index, ("sum", tuple(x.shape), x.dtype), x)
        total = parts[0].to(x.device)
        for part in parts[1:]:
            total = total + part.to(x.device)
        return total


def current() -> Optional[Strip]:
    """The strip this thread runs, or None outside a sharded call."""
    return _STRIP.get()


def enter(strip: Strip):
    """Make `strip` the current strip of this thread (a token for `leave`)."""
    return _STRIP.set(strip)


def leave(token) -> None:
    _STRIP.reset(token)


def global_rows(local_rows: int) -> int:
    """The frame's rows at the resolution of a tensor that holds
    `local_rows`: `local_rows` itself outside a sharded call."""
    strip = current()
    return local_rows if strip is None else strip.global_rows(local_rows)


def first_row(local_rows: int) -> int:
    """The frame row of a tensor's first row (0 outside a sharded call)."""
    strip = current()
    return 0 if strip is None else strip.span(local_rows)[0]


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax 'SAME' padding (low, high) of an axis of n at kernel k, stride s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv(x)` for an NCHW conv that pads 'SAME' (odd k at stride 1 with
    padding k // 2, or SameConv2d's strided 'SAME').  In a strip it fetches
    the input rows that its output rows read, the neighbours' rows and the
    zero padding at the frame's top and bottom, and convolves them without
    row padding; a conv that reads only its own rows (1x1, or k <= stride
    without padding) fetches nothing."""
    strip = current()
    if strip is None:
        return conv(x)
    k, s = conv.kernel_size[0], conv.stride[0]
    start, stop = strip.span(x.shape[2])
    if start % s or stop % s:
        raise ValueError(f"strip rows {start}..{stop} do not align with stride {s}")
    top, _ = _same_pads(strip.global_rows(x.shape[2]), k, s)
    rows = x
    if top or k > s:
        rows = strip.fetch(x, 2, start - top, stop - s - top + k)
    left, right = _same_pads(x.shape[3], k, s)
    return F.conv2d(F.pad(rows, (left, right)), conv.weight, conv.bias, conv.stride, 0, conv.dilation,
                    conv.groups)


def depthwise_rows(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The input rows of NHWC x [B, H, W, C] that a stride-1 'SAME' k x k
    depthwise conv reads for its H output rows, and the zero rows (top,
    bottom) it pads them with: (x, (k // 2, k // 2)) outside a strip; in a
    strip, the neighbours' rows within k // 2 of its own, fetched, and the
    padding only where that reaches past the frame's top or bottom.  The
    padding is left to the caller (kernels/depthwise.py), so that a
    prologue the kernel applies to the rows does not reach the zeros."""
    strip = current()
    h = k // 2
    if strip is None or h == 0:
        return x, (h, h)
    start, stop = strip.span(x.shape[1])
    total = strip.global_rows(x.shape[1])
    lo, hi = max(start - h, 0), min(stop + h, total)
    return strip.fetch(x, 1, lo, hi), (lo - (start - h), stop + h - hi)
