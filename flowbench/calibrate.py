#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one process
on the card (the benchmark's own runs never run this):

    python3 flowbench/calibrate.py --workload memflow-stream-1080p --seeds 12 \
        --planted control:3,memory_unchanged:3

Every reading is a whole run of the cell (harness.run_cell) with a window of
one call (a whole segment), checked as every run checks it, at the cell's
own size:
- lower: the program as it is, on each seed;
- planted: the same with one of faults.py's plants in the timed path (the
  fp8 control in the program's place, or a fault), on the first seeds; each
  has to come out not correct.

Prints one JSON line per reading (the compared numbers, `correct`, and each
checked frame's mean and largest gap and mean flow, in pixels) and a summary:
the largest lower reading and the smallest planted reading of each number."""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from flowbench import faults, harness  # noqa: E402

SEED0 = 3_000_000_011


def reading(cell: str, seed: int, kind: str) -> dict:
    keep = {}
    res = harness.run_cell(cell, seed, 0.001, False, "cuda", patch=faults.PLANTED.get(kind), keep=keep)
    torch.cuda.empty_cache()
    return {"reading": kind, "seed": seed, "correct": res["correct"],
            **{k: c["value"] for k, c in res["checked"].items()},
            "frames": getattr(keep["route"], "frame_gaps", None)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seed0", type=int, default=SEED0)
    p.add_argument("--seed-list", type=str, default="", help="comma-separated seeds instead of --seeds")
    p.add_argument("--planted", type=str, default="control:3",
                   help="comma-separated <plant>:<number of seeds>, plants from faults.PLANTED")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list
             else [args.seed0 + 7919 * k for k in range(args.seeds)])
    runs = [("lower", s) for s in seeds]
    for item in filter(None, args.planted.split(",")):
        kind, n = item.split(":")
        if kind not in faults.PLANTED:
            raise SystemExit(f"calibrate: no plant {kind!r}; there are {sorted(faults.PLANTED)}")
        runs += [(kind, s) for s in seeds[: int(n)]]
    summary = {}
    for kind, seed in runs:
        r = reading(args.workload, seed, kind)
        print(json.dumps(r), flush=True)
        into = summary.setdefault(kind, {"correct": []})
        into["correct"].append(r["correct"])
        for k, v in r.items():
            if k not in ("reading", "seed", "correct", "frames"):
                into[k] = max(into.get(k, v), v) if kind == "lower" else min(into.get(k, v), v)
    print(json.dumps({"summary": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
