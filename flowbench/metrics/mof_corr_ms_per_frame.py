"""mof_corr_ms_per_frame (layer: core/corr dense pyramid build): device time
of the program's span tpuflow.mof.corr (MOFNet's correlation build: each
window's dense pyramids, the GEMMs of the centre frames' features against
their neighbours' pooled ones) over the traced call, from the program's own
registry (flowbench/spans.py), per delivered frame.  Moves frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.mof.corr"


def read(run, traced):
    return spans.device_ms_per_frame(SPAN, traced)
