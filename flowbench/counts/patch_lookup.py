"""Operations and bytes of FlashCorr2's lookups, the work kernel K3 does, from
the route's `patch_lookups()`: (lookups, queries a lookup, levels, radius,
channels) per delivered frame.

FlashCorr2 keeps no volume: each lookup recomputes, for each query and
level, the correlations that the query's bilinear window reads.

- Operations: the window's (2r + 2)^2 integer taps, each a product of the
  query's C features with one pooled target feature: 2 (2r + 2)^2 C a query
  and level (counted whole: a tap off the plane still costs a kernel that
  computes it), at the card's 989 TFLOP/s in bfloat16.
- Bytes: each tensor once a lookup, whatever the launch split: the query
  features (C a query), each level's pooled target features (the target
  grid is the query grid, pooled 2 x 2 a level: C a query over 4^l; the odd
  row or column a pooling drops is counted, about 0.1 % of a lookup's bytes
  at 1080p), the flow (two float32 a query), and the (2r + 1)^2 outputs a
  query and level in bfloat16, the width the refinement consumes them in.
  The features are in the configuration's dtype (`feature_itemsize`).
  Over the card's 3.35 TB/s.

The least time is the larger of the two (counts.least_seconds).  A route
that declares no patch lookups gets None."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

FLOW_BYTES = 2 * 4
OUT_ITEMSIZE = 2


def patch_lookup_work(lookups: int, queries: int, levels: int, radius: int, channels: int,
                      feature_itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of `lookups` lookups of `queries` queries."""
    ops = lookups * queries * levels * 2 * (2 * radius + 2) ** 2 * channels
    feats = queries * channels * feature_itemsize
    targets = sum(feats // 4**level for level in range(levels))
    out = queries * levels * (2 * radius + 1) ** 2 * OUT_ITEMSIZE
    return ops, lookups * (feats + targets + queries * FLOW_BYTES + out)


def k3_per_frame(route) -> Optional[Tuple[int, int]]:
    """K3's (operations, bytes) per delivered frame, as `route` declares its
    patch lookups; None where it declares none."""
    work = getattr(route, "patch_lookups", None)
    if work is None:
        return None
    itemsize = torch.empty((), dtype=getattr(torch, route.run.config["dtype"])).element_size()
    return patch_lookup_work(*work(), feature_itemsize=itemsize)
