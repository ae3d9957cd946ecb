"""k9_roofline (layer: core/memflownet reader, K9): the float32 operations of
the exact readout over the valid slots the traffic fills
(counts/memory_read.py, from the route's `memory_reads()`), over the card's
67 TFLOP/s outside the tensor cores, times the traced call's frames, over
K9's device time in the trace (kernels named memory_read_kernel); nothing
where the route declares no memory reads or the trace holds no K9.  Moves
frames_per_s."""

from flowbench.counts import memory_read

UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "memory_read_kernel"


def read(run, traced):
    seconds = traced.kernel_seconds(KERNEL)
    least = memory_read.k9_seconds_per_frame(run.route)
    if seconds <= 0 or traced.frames == 0 or least is None:
        return None
    return 100.0 * least * traced.frames / seconds
