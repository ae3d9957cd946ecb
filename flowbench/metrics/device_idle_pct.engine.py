"""device_idle_pct.engine (layer: device): the share of the traced call that
no kernel or copy covers (the union of the profiler's device intervals),
in the cells that report frames_per_s.  Moves frames_per_s."""

UNIT = "%"
MOVES = "frames_per_s"


def read(run, traced):
    lo, hi = traced.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - traced.busy_seconds() / ((hi - lo) / 1e6))
