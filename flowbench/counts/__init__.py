"""Operations and bytes of the benchmark's work.  What one delivered frame is
belongs to the cell's route (routes/<route>.py), which declares it from the
configuration's and the cell's shapes alone, never from the program, so each
count is the same work whatever implements it.  The formulas are here:

- `model_flops_per_frame`: the plain reference's own computation per
  delivered frame, counted by torch.utils.flop_counter.FlopCounterMode over
  the route's `reference_frame(device)` call on the meta device (matrix
  products and convolutions, as the counter counts them).
- `k2_per_frame`: GMA's aggregation, the product K2 computes, from the
  route's `aggregation()`, (rows, tokens S, width D, iterations) per
  delivered frame: per row and iteration softmax(q k^T) v over S tokens of
  width D, 4 S^2 D operations, and q, k, v and the output once each in
  bfloat16.

A route that declares no such count gets None, and its reader reads nothing.
The kernels' own counts are beside this file: K1's bytes in lookup.py, K3's
operations and bytes in patch_lookup.py, K9's operations in memory_read.py.

Published H100 SXM peaks (NVIDIA data sheet, dense): 989 TFLOP/s in
bfloat16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
HBM3, at the full power limit of 700 W.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


def model_flops_per_frame(route, device="meta") -> Optional[int]:
    """Operations of the reference per delivered frame, as `route` declares
    them; None where it declares none."""
    frame = getattr(route, "reference_frame", None)
    return None if frame is None else flops(frame(device))


def aggregation_work(rows: int, tokens: int, width: int, iterations: int) -> Tuple[int, int]:
    """(operations, bytes) of GMA's aggregation over `rows` batch rows of
    `tokens` tokens of `width`, `iterations` times."""
    return iterations * rows * 4 * tokens * tokens * width, iterations * rows * 4 * tokens * width * 2


def k2_per_frame(route) -> Optional[Tuple[int, int]]:
    """(operations, bytes) of GMA's aggregation per delivered frame, as
    `route` declares it; None where it declares none."""
    work = getattr(route, "aggregation", None)
    return None if work is None else aggregation_work(*work())


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
