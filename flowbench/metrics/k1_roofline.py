"""k1_roofline (layer: kernels/denselookup, K1): the least time of the dense
pyramids' lookups over the traced call's frames (counts/lookup.py, from the
cell's route: each query's bilinear window on each level read once, its
flow read and its bfloat16 features written once, over 3.35 TB/s) over K1's
device time in the trace (kernels named dense_lookup_kernel); nothing where
the route declares no lookups or the trace holds no K1.  Moves
frames_per_s."""

from flowbench import counts
from flowbench.counts import lookup

UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "dense_lookup_kernel"


def read(run, traced):
    seconds = traced.kernel_seconds(KERNEL)
    nbytes = lookup.k1_bytes_per_frame(run.route)
    if seconds <= 0 or traced.frames == 0 or nbytes is None:
        return None
    return 100.0 * counts.least_seconds(0, nbytes) * traced.frames / seconds
