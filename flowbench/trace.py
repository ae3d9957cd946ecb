"""Reductions of one traced call (torch.profiler over CPU and CUDA): device
intervals, their union, device time by kernel name, idle gaps named by what
the host was doing, and the breakdown the result line carries."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ANNOTATION_PREFIX = "flowbench."


@dataclass
class Traced:
    """One traced call: its frames, its synchronized wall, and the profiler's
    device and host events as (name, start us, end us)."""

    frames: int = 0
    wall_s: float = 0.0
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    def kernel_seconds(self, marker: str) -> float:
        """Device seconds of the events whose name holds `marker`."""
        return sum(e - s for n, s, e in self.device if marker in n) / 1e6

    def busy_seconds(self) -> float:
        """Seconds of the traced window covered by some device event."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches with no device event, each named by the
        innermost host operation running at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) / 2
            inner: Optional[Tuple[str, float, float]] = None
            for h in self.host:
                if h[1] <= mid <= h[2] and (inner is None or h[1] >= inner[1]):
                    inner = h
            out.append((inner[0] if inner else "host: no traced op", (e - s) / 1e6))
        return out

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def from_profiler(prof, frames: int, wall_s: float, t_open_us: float, t_close_us: float) -> Traced:
    """A Traced from a finished torch.profiler.profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.events():
        rng = ev.time_range
        if ev.device_type != cuda:
            host.append((ev.name, float(rng.start), float(rng.end)))
        elif not ev.name.startswith(ANNOTATION_PREFIX):
            # The harness's own annotation is mirrored on the device's
            # timeline; it is no device work.
            dev.append((ev.name, float(rng.start), float(rng.end)))
    return Traced(frames=frames, wall_s=wall_s, device=dev, host=host, window=(t_open_us, t_close_us))
