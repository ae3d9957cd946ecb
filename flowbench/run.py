#!/usr/bin/env python3
"""The benchmark of tpuflow_torch (see flowbench/harness.py):

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress on standard error and, as its last line of standard output,
one JSON object: correct, attempted, failed, metrics, device, (with --trace 1)
breakdown, and the compared numbers with their limits under "checked"."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The repository's root, in place of this directory: the program and the
# package `flowbench` import from there, and no file here shadows a module.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from flowbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
