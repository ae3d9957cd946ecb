"""Operations of MemFlow's memory readout, the work kernel K9 does, from the
route's `memory_reads()`: (valid slots read per delivered frame, queries,
keys a slot, key width dk, value width dv).

The readout is specified in exact float32 (ROADMAP.md's departures): per
valid slot, the scores of every query against the slot's keys (2 Nq Nk dk)
and the weighted sum of its values (2 Nq Nk dv); the softmax's exponentials
are not counted.  The least time is those operations over the card's
float32 rate outside the tensor cores, 67 TFLOP/s (counts.F32_FLOP_PER_S).
Its bytes (the valid slots' float32 keys and values, the query and the
readout, each once) take under 0.2 % of that time at 1080p, so the count
leaves them out.  The slots are counted from the traffic, never from the
program: a route that declares no memory reads gets None."""

from __future__ import annotations

from typing import Optional

from flowbench import counts


def readout_ops(slots: float, queries: int, keys: int, dk: int, dv: int) -> float:
    """Operations of reading `slots` valid slots of `keys` keys each for
    `queries` queries."""
    return slots * 2 * queries * keys * (dk + dv)


def k9_seconds_per_frame(route) -> Optional[float]:
    """K9's least time per delivered frame, as `route` declares its memory
    reads; None where it declares none."""
    work = getattr(route, "memory_reads", None)
    return None if work is None else readout_ops(*work()) / counts.F32_FLOP_PER_S
