"""Small CPU sizes for driving the benchmark's cell in tests: its
configuration's widths with two refinement iterations, on
frames of 128 rows (the smallest height whose fourth correlation level
has two rows)."""

DEPTH = {"model_config": {"decoder_depth": 2}, "reference_args": {"decoder_depth": 2}}
TRAFFIC = {"height": 128, "sprite_min_px": 16, "sprite_max_px": 48, "pan_max_px": 4,
           "sprite_speed_max_px": 6, "texture_cell_px": 8}


def memflow(frames: int = 10) -> dict:
    return {**DEPTH, "traffic": {**TRAFFIC, "width": 128, "segment_frames": frames, "segments": 2}}
