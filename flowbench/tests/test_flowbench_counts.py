"""The counts: the model's operations on the meta device are those of a real
run at a small shape, and K2's count is the hand count of GMA's
aggregation."""

from flowbench import counts, spec as spec_mod

CONFIG = "memflow-t"


def config(depth=None):
    cfg = spec_mod.Spec().config(CONFIG)
    if depth:
        cfg = {**cfg, "model_config": {**cfg["model_config"], "decoder_depth": depth},
               "reference_args": {**cfg["reference_args"], "decoder_depth": depth}}
    return cfg


def test_meta_count_is_a_real_runs_count():
    cfg = config(depth=1)
    traffic = {"width": 128, "height": 128}
    meta = counts.model_flops_per_frame(cfg, traffic, device="meta")
    real = counts.model_flops_per_frame(cfg, traffic, device="cpu")
    assert meta == real > 0


def test_k2_hand_count():
    # An untiled 1080p frame: 135 x 240 tokens, 12 iterations.
    s = 135 * 240
    assert counts.k2_per_frame(config(), {"width": 1920, "height": 1080}) == (
        12 * 4 * s * s * 128, 12 * 4 * s * 128 * 2)
    # The bound of one [1, 32400] aggregation is compute: 0.5435 ms.
    assert abs(counts.least_seconds(4 * s * s * 128, 4 * s * 128 * 2) - 0.5435e-3) < 1e-7
