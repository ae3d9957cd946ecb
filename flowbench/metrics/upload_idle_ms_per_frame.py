"""upload_idle_ms_per_frame (layer: engine entry (upload)): the traced
call's idle device time (the window less the union of its device events,
any annotation's mirror left out) that falls inside the program's host
spans tpuflow.engine.upload (FlowEngine._upload: the frame made contiguous
and copied to the card, cast, scaled and padded), per delivered frame.  The
spans are host events of the same trace, on the kernels' clock
(flowbench/spans.py).  Moves frames_per_s."""

from flowbench import spans

UNIT = "ms/frame"
MOVES = "frames_per_s"
SPAN = "tpuflow.engine.upload"


def read(run, traced):
    if not traced.device or traced.frames == 0:
        return None
    uploads = spans.host_intervals(traced, name=SPAN)
    if not uploads:
        return None
    return spans.overlap(spans.idle_intervals(traced), uploads) / 1e3 / traced.frames
