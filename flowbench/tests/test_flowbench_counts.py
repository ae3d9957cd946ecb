"""The counts: each cell's route declares one delivered frame's work, and the
formulas in counts/ turn it into operations and bytes.  The model's
operations on the meta device are those of a real run at a small shape;
K2's count is the hand count of GMA's aggregation; the MemFlow cell's counts
are pinned to the integers they have been since the benchmark began; a route
that declares no count leaves both count readers without a reading."""

from types import SimpleNamespace

import pytest

from flowbench import counts, harness, spec as spec_mod

CELL = "memflow-stream-1080p"
SPEC = spec_mod.Spec()


def route(overrides=None):
    run = harness.Run(CELL, 2**31 + 13, 1, False, "cpu", 0.0, SPEC, overrides)
    return SPEC.route_module(run.cell["route"]).Route(run)


def test_meta_count_is_a_real_runs_count():
    r = route({"model_config": {"decoder_depth": 1}, "reference_args": {"decoder_depth": 1},
               "traffic": {"width": 128, "height": 128}})
    meta = counts.model_flops_per_frame(r, device="meta")
    real = counts.model_flops_per_frame(r, device="cpu")
    assert meta == real > 0


def test_k2_hand_count():
    # An untiled 1080p frame: 135 x 240 tokens, 12 iterations.
    s = 135 * 240
    assert counts.k2_per_frame(route()) == (12 * 4 * s * s * 128, 12 * 4 * s * 128 * 2)
    # The bound of one [1, 32400] aggregation is compute: 0.5435 ms.
    assert abs(counts.least_seconds(4 * s * s * 128, 4 * s * 128 * 2) - 0.5435e-3) < 1e-7


def test_memflow_counts_are_pinned():
    # As counts computed them from the configuration and the traffic before
    # the routes declared them.
    r = route()
    assert r.aggregation() == (1, 32400, 128, 12)
    assert counts.k2_per_frame(r) == (6_449_725_440_000, 398_131_200)
    assert counts.model_flops_per_frame(r) == 11_998_172_434_944


def test_k2_hand_count_of_a_tiled_mof_window():
    # A tiled 1080p MOF frame: two 960 x 1080 tiles, three interior frames
    # of a five-frame window, 135 x 120 tokens, 12 iterations.
    s = 135 * 120
    assert counts.aggregation_work(2 * 3, s, 128, 12) == (9_674_588_160_000, 1_194_393_600)
    assert counts.aggregation_work(6, s, 128, 12) == (12 * 6 * 4 * s * s * 128, 12 * 6 * 4 * s * 128 * 2)


@pytest.mark.parametrize("name", ["step_mfu_pct", "k2_roofline"])
def test_a_route_without_counts_gets_no_reading(name):
    run = SimpleNamespace(route=object())
    traced = SimpleNamespace(frames=4, wall_s=1.0, kernel_seconds=lambda marker: 0.5)
    assert SPEC.metric_module(name).read(run, traced) is None
