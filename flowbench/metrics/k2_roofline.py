"""k2_roofline (layer: kernels/flashattn, K2): the least time of GMA's
aggregation over the traced call's frames (counts.k2_per_frame: the larger
of its operations over 989 TFLOP/s and its bytes over 3.35 TB/s) over K2's
device time in the trace (kernels named flash_fwd).  Moves frames_per_s."""

from flowbench import counts

UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "flash_fwd"


def read(run, traced):
    seconds = traced.kernel_seconds(KERNEL)
    if seconds <= 0 or traced.frames == 0:
        return None
    ops, nbytes = counts.k2_per_frame(run.config, run.traffic)
    return 100.0 * counts.least_seconds(ops, nbytes) * traced.frames / seconds
