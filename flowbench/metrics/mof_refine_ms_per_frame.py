"""mof_refine_ms_per_frame (layer: core/mofnet refine (K1, MOF SK blocks,
K2)): device time of the program's span tpuflow.mof.refine (MOFNet.refine:
the twelve joint bidirectional iterations, their lookups in K1, the SK
update blocks with GMA's aggregation in K2, and the convex upsample) over
the traced call, from the program's own registry (flowbench/spans.py), per
delivered frame.  Moves frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.mof.refine"


def read(run, traced):
    return spans.device_ms_per_frame(SPAN, traced)
