#!/usr/bin/env python3
"""Checks of the program's spans in whole runs of a cell, on the card (the
benchmark's own runs never run this):

    python3 flowbench/spancheck.py --workload memflow-stream-1080p --traced 6200628383,6200733113
    python3 flowbench/spancheck.py --workload memflow-stream-1080p --cost 3

--traced: one traced run per seed (harness.run_cell, as run.py with --trace
1), and one JSON line each: the metrics and the breakdown's idle gaps; the
device events that bear a program span's name (there must be none); the
device's idle time, the share of it that no program span covers on the
host, and what the host was doing then (the longest pieces named by the
innermost host event at their middle); each span's device time from the
registry, and the sum of the model step's four (encode, read, refine,
write) over the busy time.

--spans-off: the same traced runs with the program's spans left off, so
that their cost under the profiler shows against runs with them on.

--cost: 2 x N untraced runs in one process, spans off and on (enable()
through run_cell's patch) in turns from the seeds given or drawn, one JSON
line each with frames_per_s, then the medians of both."""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flowbench import harness, spans, trace as trace_mod  # noqa: E402

STEP = ("tpuflow.memflow.encode", "tpuflow.memflow.read", "tpuflow.memflow.refine", "tpuflow.memflow.write")
SEED0 = 7_300_000_019
NAMED_PIECES = 300


def traced(cell: str, seed: int, seconds: float, spans_on: bool = True) -> dict:
    from tpuflow_torch.runtime import profiling

    got = {}
    orig, install = trace_mod.from_profiler, spans.install

    def capture(*args, **kw):
        got["traced"] = orig(*args, **kw)
        return got["traced"]

    trace_mod.from_profiler = capture
    if not spans_on:
        spans.install = lambda run: None
    try:
        res = harness.run_cell(cell, seed, seconds, True, "cuda")
    finally:
        trace_mod.from_profiler, spans.install = orig, install
    tr = got["traced"]
    lo, hi = tr.window
    idle = spans.idle_intervals(tr)
    idle_us = sum(e - s for s, e in idle)
    ours = spans.host_intervals(tr, prefix=spans.PROGRAM_PREFIX)
    covered = spans.overlap(idle, ours)
    # The idle time outside every program span, each piece named by the
    # innermost host event at its middle.
    pieces = sorted(spans.intersect(idle, spans.complement(ours, lo, hi)), key=lambda p: p[0] - p[1])
    starts = np.array([h[1] for h in tr.host])
    ends = np.array([h[2] for h in tr.host])
    by_name, named = {}, []
    for k, (s, e) in enumerate(pieces):
        name = "shorter pieces"
        if k < NAMED_PIECES:
            mid = (s + e) / 2
            inside = np.flatnonzero((starts <= mid) & (mid <= ends))
            name = tr.host[inside[np.argmax(starts[inside])]][0] if len(inside) else "host: no traced op"
            named.append((name, (e - s) / 1e3, (s - lo) / 1e3))
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    busy_s = tr.busy_seconds()
    reg = profiling.snapshot()["spans"]
    step = [reg[n]["device_s"] for n in STEP if n in reg and reg[n]["device_s"] is not None]
    return {
        "seed": seed, "spans_on": spans_on, "correct": res["correct"], "frames": tr.frames,
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "idle_gaps": res["breakdown"]["idle_gaps"],
        "device_events_named_tpuflow": sorted({n for n, _, _ in tr.device if spans.PROGRAM_PREFIX in n}),
        "window_s": (hi - lo) / 1e6, "busy_s": busy_s, "idle_s": idle_us / 1e6,
        "idle_unattributed_pct": 100.0 * (1.0 - covered / idle_us) if idle_us else None,
        "idle_unattributed_ms_by_host_op": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
        "idle_unattributed_longest": named[:12],
        "spans": {n: {"calls": s["calls"], "host_ms_per_frame": 1e3 * s["host_s"] / tr.frames,
                      "device_ms_per_frame": None if s["device_s"] is None else 1e3 * s["device_s"] / tr.frames}
                  for n, s in reg.items()},
        "step_device_over_busy_pct": 100.0 * sum(step) / busy_s if len(step) == len(STEP) else None,
    }


def cost(cell: str, seeds, seconds: float) -> dict:
    from tpuflow_torch.runtime import profiling

    def spans_on(run, route):
        profiling.clear()
        profiling.enable()

    rates = {"off": [], "on": []}
    for seed in seeds:
        for mode in ("off", "on"):
            res = harness.run_cell(cell, seed, seconds, False, "cuda", patch=spans_on if mode == "on" else None)
            profiling.disable()
            profiling.clear()
            torch.cuda.empty_cache()
            rate = res["metrics"]["frames_per_s"]["value"]
            rates[mode].append(rate)
            print(json.dumps({"seed": seed, "spans": mode, "frames_per_s": rate, "correct": res["correct"]}),
                  flush=True)
    return {k: statistics.median(v) for k, v in rates.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=None, help="the window (default: run_seconds)")
    p.add_argument("--traced", type=str, default="", help="comma-separated seeds of traced runs")
    p.add_argument("--spans-off", action="store_true",
                   help="--traced with the program's spans left off (their cost under the profiler)")
    p.add_argument("--cost", type=int, default=0, help="pairs of untraced runs, spans off and on")
    p.add_argument("--cost-seeds", type=str, default="", help="comma-separated seeds for --cost")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("spancheck: needs a CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json")
                                         .read_text())["run_seconds"]
    for seed in filter(None, args.traced.split(",")):
        print(json.dumps(traced(args.workload, int(seed), seconds, not args.spans_off)), flush=True)
        torch.cuda.empty_cache()
    if args.cost:
        seeds = ([int(s) for s in args.cost_seeds.split(",")] if args.cost_seeds
                 else [SEED0 + 7919 * k for k in range(args.cost)])
        print(json.dumps({"median_frames_per_s": cost(args.workload, seeds, seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
