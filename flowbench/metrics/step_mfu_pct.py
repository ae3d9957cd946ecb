"""step_mfu_pct (layer: model step): the reference's operations per
delivered frame, as the cell's route declares them
(counts.model_flops_per_frame), times the traced call's frames, over its
synchronized wall, as a share of the card's bfloat16 peak (989 TFLOP/s,
H100 SXM); nothing where the route declares no count.  Moves
frames_per_s."""

from flowbench import counts

UNIT = "%"
MOVES = "frames_per_s"


def read(run, traced):
    if traced.frames == 0:
        return None
    ops = counts.model_flops_per_frame(run.route)
    if ops is None:
        return None
    return 100.0 * ops * traced.frames / traced.wall_s / counts.BF16_FLOP_PER_S
