"""reader_ms_per_frame (layer: core/memflownet reader, MemFlow's memory
reader: the float32 scores of this frame's key against every valid slot,
their softmax and the readout): device time of the program's span
tpuflow.memflow.read (MemoryReader.forward) over the traced call, from the
program's own registry (flowbench/spans.py), per delivered frame.  Moves
frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.memflow.read"

install = spans.install


def read(run, traced):
    return spans.device_ms_per_frame(SPAN, traced)
