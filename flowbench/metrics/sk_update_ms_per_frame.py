"""sk_update_ms_per_frame (layer: core/sk, the SK update block with GMA's
aggregation and K2 inside it): CUDA events recorded around each call of the
model's `update_block` (its refinement step and its mask head: the program
calls them as methods, so they are wrapped on the instance, not hooked),
summed over the traced call, per delivered frame.  Moves frames_per_s."""

import torch

UNIT = "ms/frame"
MOVES = "frames_per_s"
METHODS = ("step", "upsample_mask")

_events = []


def install(run):
    block = getattr(getattr(run.engine, "model", None), "update_block", None)
    if block is None or run.device.type != "cuda":
        return None
    _events.clear()

    def wrap(orig):
        def timed(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kw)
            b.record()
            _events.append((a, b))
            return out
        return timed

    names = [m for m in METHODS if hasattr(block, m)]
    for m in names:
        setattr(block, m, wrap(getattr(block, m)))
    return lambda: [delattr(block, m) for m in names]


def read(run, traced):
    if not _events or traced.frames == 0:
        return None
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in _events) / traced.frames
