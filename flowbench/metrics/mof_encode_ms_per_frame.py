"""mof_encode_ms_per_frame (layer: core/mofnet encode (Twins fnet/cnet)):
device time of the program's span tpuflow.mof.encode over the traced call,
from the program's own registry (flowbench/spans.py), per delivered frame.
On the tiled stride-1 path the span wraps MOFNet.frame_features: both Twins
encoders on each new frame's tiles, once a frame.  On the untiled path it
wraps MOFNet.encode, once a window: fnet on its 5 frames, cnet on its 3
interior ones, the context's preparation (GMA's q and k), and the nested
tpuflow.mof.corr (the correlation build, which mof_corr_ms_per_frame reads
on its own).  Moves frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.mof.encode"


def read(run, traced):
    return spans.device_ms_per_frame(SPAN, traced)
