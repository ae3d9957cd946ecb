"""mof_encode_ms_per_frame (layer: core/mofnet encode (Twins fnet/cnet)):
device time of the program's span tpuflow.mof.encode (MOFNet.frame_features
on the stride-1 path: both Twins encoders on each new frame's tiles, once a
frame) over the traced call, from the program's own registry
(flowbench/spans.py), per delivered frame.  Moves frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.mof.encode"


def read(run, traced):
    return spans.device_ms_per_frame(SPAN, traced)
