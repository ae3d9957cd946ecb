"""Bytes of the dense pyramids' lookups, the work kernel K1 does, from the
route's `lookups()`: (launches, queries a launch, levels, radius) per
delivered frame.

Each query reads, on each level, the bilinear window around its centre,
(2r + 2)^2 taps of the volume (counted whole: the window's place depends on
the flow, and a tap off the plane still costs a kernel that reads it); reads
its flow, two float32; and writes its (2r + 1)^2 features a level, once, in
bfloat16, the width the refinement consumes them in.  The volumes are in
the configuration's dtype (`volume_itemsize`).  The least time is those
bytes over the card's 3.35 TB/s (counts.least_seconds with no operations:
a lookup does no arithmetic worth a tensor core).  A route that declares
no lookups gets None."""

from __future__ import annotations

from typing import Optional

import torch

FLOW_BYTES = 2 * 4
OUT_ITEMSIZE = 2


def lookup_bytes(launches: int, queries: int, levels: int, radius: int, volume_itemsize: int = 2) -> int:
    """Bytes read and written by `launches` lookups of `queries` queries."""
    window = (2 * radius + 2) ** 2 * volume_itemsize
    out = (2 * radius + 1) ** 2 * OUT_ITEMSIZE
    return launches * queries * (levels * (window + out) + FLOW_BYTES)


def k1_bytes_per_frame(route) -> Optional[int]:
    """K1's bytes per delivered frame, as `route` declares its lookups;
    None where it declares none."""
    work = getattr(route, "lookups", None)
    if work is None:
        return None
    itemsize = torch.empty((), dtype=getattr(torch, route.run.config["dtype"])).element_size()
    return lookup_bytes(*work(), volume_itemsize=itemsize)
