"""k3_roofline (layer: kernels/flashcorr2, K3): the least time of the cell's
FlashCorr2 lookups over the traced call's frames (counts/patch_lookup.py,
from the route's `patch_lookups()`: the larger of the integer taps'
products over 989 TFLOP/s and each tensor read or written once a lookup
over 3.35 TB/s) over K3's device time in the trace (kernels named
corr_patch); nothing where the route declares no patch lookups or the trace
holds no K3.  Moves frames_per_s."""

from flowbench import counts
from flowbench.counts import patch_lookup

UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "corr_patch"


def read(run, traced):
    seconds = traced.kernel_seconds(KERNEL)
    work = patch_lookup.k3_per_frame(run.route)
    if seconds <= 0 or traced.frames == 0 or work is None:
        return None
    return 100.0 * counts.least_seconds(*work) * traced.frames / seconds
