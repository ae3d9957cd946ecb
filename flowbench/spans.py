"""The program's own spans, for the per-layer metrics that read them.

The program (tpuflow_torch/runtime/profiling.py) keeps spans and counters
in one registry.  `install(run)` clears it and turns the spans on for the
traced call (the harness installs it before that call, in every cell, and
undoes it after); `device_ms_per_frame` reads a span's device time from the
registry.  Under the profiler each span is also a host event of the trace
(`Traced.host`), on the kernels' clock.  A program without the registry
gives nothing to read: install returns None and the readers return None."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

PROGRAM_PREFIX = "tpuflow."
ANNOTATION_PREFIXES = ("flowbench.", PROGRAM_PREFIX)


def _registry():
    try:
        from tpuflow_torch.runtime import profiling
    except ImportError:
        return None
    if all(hasattr(profiling, f) for f in ("clear", "enable", "disable", "snapshot")):
        return profiling
    return None


def install(run):
    """Clear the registry and turn the spans on; returns the undo (spans
    off), or None where the program has no registry."""
    reg = _registry()
    if reg is None:
        return None
    reg.clear()
    reg.enable()
    return reg.disable


def device_ms_per_frame(span: str, traced) -> Optional[float]:
    """Device milliseconds of the program's span `span` over the traced call,
    per delivered frame; None where it recorded no device time."""
    reg = _registry()
    if reg is None or traced.frames == 0:
        return None
    s = reg.snapshot()["spans"].get(span)
    if s is None or not s["device_s"]:
        return None
    return 1e3 * s["device_s"] / traced.frames


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of intervals clipped to [lo, hi], as sorted disjoint ones."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def complement(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """[lo, hi] less the sorted disjoint `intervals`."""
    out, at = [], lo
    for s, e in intervals:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def intersect(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    return sum(e - s for s, e in intersect(a, b))


def idle_intervals(traced) -> List[Tuple[float, float]]:
    """The traced window less the union of its device events, leaving out
    any annotation's mirror (a name under flowbench. or tpuflow.)."""
    lo, hi = traced.window
    busy = union(((s, e) for n, s, e in traced.device if not n.startswith(ANNOTATION_PREFIXES)), lo, hi)
    return complement(busy, lo, hi)


def host_intervals(traced, name: Optional[str] = None, prefix: Optional[str] = None) -> List[Tuple[float, float]]:
    """The union of the host events named `name` (or under `prefix`) within
    the traced window."""
    lo, hi = traced.window
    return union(((s, e) for n, s, e in traced.host
                  if (name is not None and n == name) or (prefix is not None and n.startswith(prefix))), lo, hi)
