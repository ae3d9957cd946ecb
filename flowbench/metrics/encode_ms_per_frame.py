"""encode_ms_per_frame (layer: core/memflownet encode: the Twins fnet and
cnet, GMA's q/k, the correlation pyramid): device time of the program's span
tpuflow.memflow.encode (MemFlowNet.encode) over the traced call, from the
program's own registry (flowbench/spans.py), per delivered frame.  Moves
frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.memflow.encode"


def read(run, traced):
    return spans.device_ms_per_frame(SPAN, traced)
