"""k2_roofline (layer: kernels/flashattn, K2): the least time of GMA's
aggregation over the traced call's frames (counts.k2_per_frame, from the
cell's route: the larger of its operations over 989 TFLOP/s and its bytes
over 3.35 TB/s) over K2's device time in the trace (kernels named
flash_fwd); nothing where the route declares no count.  Moves
frames_per_s."""

from flowbench import counts

UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "flash_fwd"


def read(run, traced):
    seconds = traced.kernel_seconds(KERNEL)
    work = counts.k2_per_frame(run.route)
    if seconds <= 0 or traced.frames == 0 or work is None:
        return None
    return 100.0 * counts.least_seconds(*work) * traced.frames / seconds
