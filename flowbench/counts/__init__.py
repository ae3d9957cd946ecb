"""Operations and bytes of the benchmark's work, computed from each
configuration's and cell's shapes and never read from the program, so they
count the same work whatever implements it.

- `model_flops_per_frame`: the plain reference's own computation per
  delivered frame, counted by torch.utils.flop_counter.FlopCounterMode over
  the reference on the meta device (matrix products and convolutions, as
  the counter counts them).  A MemFlow frame encodes its pair, as the
  reference does.
- `k2_per_frame`: GMA's aggregation, the product K2 computes: per
  refinement iteration, softmax(q k^T) v over S = h/8 * w/8 tokens of width
  D = context_dim: 4 S^2 D operations, and q, k, v and the output once
  each in bfloat16.

Published H100 SXM peaks (NVIDIA data sheet, dense): 989 TFLOP/s in
bfloat16, 3.35 TB/s of HBM3, at the full power limit of 700 W.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import reference_model

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


def model_flops_per_frame(config: dict, traffic: dict, device="meta") -> int:
    """Operations of the reference per delivered frame: one pair of padded
    frames through the MemFlow reference."""
    model = reference_model(config, device)
    h, w = traffic["height"], traffic["width"]
    ph, pw = h + (-h) % 8, w + (-w) % 8
    pair = torch.zeros(1, 2, 3, ph, pw, device=device)
    mem = model.empty_memory(1, ph, pw, device)
    return flops(lambda: model(pair, mem))


def k2_per_frame(config: dict, traffic: dict) -> Tuple[int, int]:
    """(operations, bytes) of GMA's aggregation per delivered frame."""
    mc = config["model_config"]
    s = math.ceil(traffic["height"] / 8) * math.ceil(traffic["width"] / 8)
    d = mc["context_dim"]
    return mc["decoder_depth"] * 4 * s * s * d, mc["decoder_depth"] * 4 * s * d * 2


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
