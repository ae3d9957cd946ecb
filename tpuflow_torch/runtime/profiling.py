"""The port's tracing: spans and counters in one registry, and the profiler
around them.

- `span(name)`: a named stretch of the program, as a method decorator or a
  context manager.  Off (the default) a span costs one test of a module
  flag.  On (`enable()`), each call
  (a) opens a host range in torch.profiler's event stream, so that under a
      running profiler the span is a host event on the kernels' clock.  The
      range is a `_RecordFunctionFast` (a function-scope record, not a user
      annotation), so the profiler mirrors nothing of it on the device's
      timeline;
  (b) records a CUDA event pair on the current stream of the current card,
      when CUDA is in use: the span's device time;
  (c) adds its calls, host seconds and device seconds to its name.  Event
      pairs are resolved as soon as `query()` finds them complete, so a long
      job holds few; `snapshot()` resolves the rest with one wait.
  Spans nest, and threads may open them at once (the spatial strips launch
  from threads of their own).
- `count(name, n)`: integer counters, counted whether tracing is on or off
  (the kernels' launches, nvcc builds, the engine's frames and bytes).
- `enable()`, `disable()`, `clear()`, `snapshot()`: the records outlive
  `disable()` until the next `clear()`.
- `report(snap)`: the per-span table; `trace_to(dir)`: the spans on and the
  profiler around a block, then `dir/spans.json` and the table (the CLI's
  `--trace-dir`); `device_trace`: torch.profiler around a block, writing a
  Chrome trace; `flow_statistics`: per-frame flow stats.

Span names are `tpuflow.<layer>.<stage>`; counter names `<layer>.<what>`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import socket
import threading
import time
from typing import Dict, Iterator, Optional

import torch

_ENABLED = False
# Context-manager spans open now, in every thread (their exits look at their
# thread's stack only while this is non-zero).
_CM_OPEN = 0
_lock = threading.Lock()
_local = threading.local()
# name -> [calls, host seconds, device seconds, device-timed calls]
_spans: Dict[str, list] = {}
_counters: Dict[str, int] = {}
# (name, start event, end event), in the order the spans closed.
_pending: collections.deque = collections.deque()
# The profiler's function-scope range (absent from older torch: then a span
# opens no host range).
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def enable() -> None:
    """Spans record from now on."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Spans stop recording; what they recorded stays until `clear()`."""
    global _ENABLED
    _ENABLED = False


def clear() -> None:
    """Forget every span's record, every counter and every pending event."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _pending.clear()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (on or off)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _open(name: str) -> tuple:
    t0 = time.perf_counter()
    rf = None
    if _RANGE is not None:
        rf = _RANGE(name)
        rf.__enter__()
    start = None
    if torch.cuda.is_initialized():
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    return name, t0, rf, start


def _close(rec: tuple) -> None:
    name, t0, rf, start = rec
    end = None
    if start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    if rf is not None:
        rf.__exit__(None, None, None)
    host = time.perf_counter() - t0
    with _lock:
        s = _spans.get(name)
        if s is None:
            s = _spans[name] = [0, 0.0, 0.0, 0]
        s[0] += 1
        s[1] += host
        if end is not None:
            _pending.append((name, start, end))
        _resolve(wait=False)


def _resolve(wait: bool) -> None:
    """Fold completed event pairs into their spans, oldest first (all of
    them, waiting for each, when `wait`).  Holds _lock."""
    while _pending:
        name, start, end = _pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        s = _spans[name]
        s[2] += start.elapsed_time(end) / 1e3
        s[3] += 1


class span:
    """A named span: `@span("tpuflow.memflow.read")` on a method or function,
    or `with span(...)`.  Reuse one object across calls and threads."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _ENABLED:
                return fn(*args, **kwargs)
            rec = _open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(rec)

        return traced

    def __enter__(self) -> None:
        global _CM_OPEN
        if _ENABLED:
            stack = _local.__dict__.setdefault("stack", [])
            stack.append((self, _open(self.name)))
            with _lock:
                _CM_OPEN += 1

    def __exit__(self, *exc) -> None:
        global _CM_OPEN
        if _CM_OPEN:
            stack = _local.__dict__.get("stack")
            if stack and stack[-1][0] is self:
                _close(stack.pop()[1])
                with _lock:
                    _CM_OPEN -= 1


def snapshot() -> dict:
    """{"spans": {name: {"calls", "host_s", "device_s"}}, "counters":
    {name: n}}, after waiting for every span's events; device_s is None for
    a span that recorded no event pair (CUDA unused)."""
    with _lock:
        _resolve(wait=True)
        spans = {
            name: {"calls": s[0], "host_s": s[1], "device_s": s[2] if s[3] else None}
            for name, s in _spans.items()
        }
        return {"spans": spans, "counters": dict(_counters)}


def report(snap: Optional[dict] = None, frames: Optional[int] = None) -> str:
    """The per-span table of a snapshot (default: now), longest host time
    first; per-frame columns when `frames` is given."""
    snap = snapshot() if snap is None else snap
    per = f"  {'host ms/frame':>13} {'dev ms/frame':>12}" if frames else ""
    lines = [f"{'span':<32} {'calls':>7} {'host s':>9} {'device s':>9}{per}"]
    for name, s in sorted(snap["spans"].items(), key=lambda kv: -kv[1]["host_s"]):
        dev = s["device_s"]
        row = f"{name:<32} {s['calls']:7d} {s['host_s']:9.3f} {'-' if dev is None else f'{dev:.3f}':>9}"
        if frames:
            dev_pf = "-" if dev is None else f"{1e3 * dev / frames:.2f}"
            row += f"  {1e3 * s['host_s'] / frames:13.2f} {dev_pf:>12}"
        lines.append(row)
    for name, n in sorted(snap["counters"].items()):
        lines.append(f"{name:<32} {n:7d}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: Optional[str], name: str = "spans.json") -> Iterator[None]:
    """The block with the spans on and under `device_trace(logdir)`, so that
    its Chrome trace shows the program's spans and kernels on one clock;
    then `logdir/name` (per span calls, host and device seconds; every
    counter; per-frame figures over `engine.frames`) and the per-span table
    on standard output.  The registry is cleared first.  No-op without a
    `logdir`."""
    if not logdir:
        yield
        return
    clear()
    enable()
    try:
        with device_trace(logdir):
            yield
    finally:
        disable()
    snap = snapshot()
    frames = snap["counters"].get("engine.frames", 0)
    if frames:
        snap["per_frame"] = {
            "frames": frames,
            "spans": {k: {"calls": s["calls"] / frames, "host_ms": 1e3 * s["host_s"] / frames,
                          "device_ms": None if s["device_s"] is None else 1e3 * s["device_s"] / frames}
                      for k, s in snap["spans"].items()},
            "counters": {k: n / frames for k, n in snap["counters"].items()},
        }
    with open(os.path.join(logdir, name), "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    print(report(snap, frames or None))


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
