"""k3_ms_per_frame (layer: kernels/flashcorr2, K3): device time of the
kernels named corr_patch in the traced call, per delivered frame.  Moves
frames_per_s."""

UNIT = "ms/frame"
MOVES = "frames_per_s"
KERNEL = "corr_patch"


def read(run, traced):
    seconds = traced.kernel_seconds(KERNEL)
    if seconds <= 0 or traced.frames == 0:
        return None
    return 1e3 * seconds / traced.frames
