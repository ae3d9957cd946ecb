"""Tracing / profiling utilities (the JAX package's runtime/profiling.py on
torch).

- `StageTimer`: named per-stage wall-time accumulation with a
  human-readable report (a copy).
- `device_trace`: a context manager around `torch.profiler.profile`, with
  CUDA activities when a card is visible, writing a Chrome trace under
  `logdir`.
- `flow_statistics`: per-frame flow stats (min/max component, mean
  magnitude), the metadata the reference embeds in .npz saves
  (cache_manager.py:269-276), reduced on the flow's device.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                     total(s)   calls   mean(ms)"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(
                f"{name:<24} {total:9.3f} {count:7d} {1000 * total / count:10.2f}"
            )
        return "\n".join(lines)

    def mean(self, name: str) -> float:
        if not self.counts.get(name):
            return 0.0
        return self.totals[name] / self.counts[name]


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """torch.profiler trace of the block (CPU activities, and CUDA's when a
    card is visible) written under `logdir` when one is given, as
    `<host>_<pid>.<ns>.pt.trace.json` (the name TensorBoard's profiler
    plugin reads); yields the profiler, so that a caller can also read
    `key_averages()` after the block.  No-op (yields None) otherwise."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def flow_statistics(flow) -> Dict[str, torch.Tensor]:
    """min/max flow component + mean magnitude (cache_manager.py:269-276),
    as 0-d tensors on the flow's device (a numpy array is taken as a CPU
    tensor)."""
    from ..pipeline.ops import _tensor

    flow = _tensor(flow).float()
    lo, hi = torch.aminmax(flow)
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    return {"min_flow": lo, "max_flow": hi, "mean_magnitude": mag.mean()}
