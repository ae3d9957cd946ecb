"""A run of the MemFlow cell driven on the CPU at a small size, past the
look for a card, with the timed path broken underneath: `correct` comes out
false for each fault the cell can have (its window streams one frame at a
time on one card, so it has no batch to halve and no exchange between
cards), and true unbroken; and the lower-precision control, the fp8
reference in the program's place, comes out not correct (faults.py).

The cell's limits are in pixels at 1080p, where the flows of a seed's
random weights run from 10 to 190 px; at this size they are a few pixels,
and the program runs in float32, not bfloat16, on the CPU (it reads about
1e-3 px). So the run here is held to limits of this size, SMALL_LIMITS,
which the faults and the control exceed many times over."""

import pytest

from flowbench import faults, harness
from flowbench.tests import small

CELL = "memflow-stream-1080p"
SEED = 2**31 + 77
SMALL_LIMITS = {"flow_epe_px": 0.05, "flow_epe_max_px": 0.5}
SMALL = {**small.memflow(10), "cell": {"limits": SMALL_LIMITS}}


def run(patch=None):
    return harness.run_cell(CELL, SEED, 0.001, False, "cpu", overrides=SMALL, patch=patch)


def test_unbroken_run_is_correct():
    res = run()
    assert res["correct"], res["checked"]
    assert list(res)[-1] == "checked"


@pytest.mark.parametrize("plant", ["memory_unchanged", "flow_altered", "control"])
def test_planted_fault_or_control_is_caught(plant):
    res = run(faults.PLANTED[plant])
    assert not res["correct"], res["checked"]
