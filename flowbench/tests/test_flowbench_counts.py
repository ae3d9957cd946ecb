"""The counts: each cell's route declares one delivered frame's work, and the
formulas in counts/ turn it into operations and bytes.  The model's
operations on the meta device are those of a real run at a small shape;
K2's count is the hand count of GMA's aggregation, and K3's and K9's those
of FlashCorr2's lookups and of the memory's readout; the MemFlow cell's
counts are pinned to the integers they have been since the benchmark began;
a route that declares no count leaves every count reader without a
reading."""

from types import SimpleNamespace

import pytest

from flowbench import counts, harness, spec as spec_mod
from flowbench.counts import memory_read, patch_lookup

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


def test_k3_hand_count():
    # FlashCorr2's lookups a delivered frame: MemFlow 12 of 135 x 240
    # queries, untiled MOF 24 of 3 x 135 x 240; 4 levels, radius 4, 256
    # channels.
    mof = SPEC.route_module("mof_untiled").Route(route().run)
    assert route().patch_lookups() == (12, 32_400, 4, 4, 256)
    assert mof.patch_lookups() == (24, 97_200, 4, 4, 256)
    # A query and level: 100 integer taps of 256 products, 51 200 operations.
    # A lookup of 97 200 queries: 49 766 400 bytes of bf16 query features,
    # the pooled targets at 1, 1/4, 1/16, 1/64 of that (66 096 000), the
    # f32 flows (777 600) and 4 x 81 bf16 outputs a query (62 985 600).
    assert patch_lookup.patch_lookup_work(1, 97_200, 4, 4, 256) == (
        97_200 * 4 * 51_200, 49_766_400 + 66_096_000 + 777_600 + 62_985_600)
    assert patch_lookup.k3_per_frame(mof) == (477_757_440_000, 4_311_014_400)
    assert patch_lookup.k3_per_frame(route()) == (79_626_240_000, 718_502_400)
    # Both bound by bytes: 1.2869 ms a MOF frame (0.0536 ms a lookup, beside
    # 0.483 ms of operations), 0.2145 ms a MemFlow frame.
    assert counts.least_seconds(*patch_lookup.k3_per_frame(mof)) == pytest.approx(4_311_014_400 / 3.35e12)
    assert 4_311_014_400 / 24 / 3.35e12 == pytest.approx(0.05362e-3, rel=1e-3)
    assert counts.least_seconds(*patch_lookup.k3_per_frame(route())) == pytest.approx(0.21448e-3, rel=1e-4)


def test_k9_hand_count():
    # Frame i of a 24-frame segment reads min(i, 8) valid slots: 156 over
    # the segment, 6.5 a frame; 135 x 240 queries and keys a slot.
    assert route().memory_reads() == (6.5, 32_400, 32_400, 64, 128)
    # Eight valid slots: 2 x 32 400^2 x (64 + 128) x 8 = 3.2249e12
    # operations, 48.13 ms at 67 TFLOP/s.
    eight = memory_read.readout_ops(8, 32_400, 32_400, 64, 128)
    assert eight == 3_224_862_720_000
    assert eight / counts.F32_FLOP_PER_S == pytest.approx(48.13e-3, rel=1e-4)
    assert memory_read.k9_seconds_per_frame(route()) == pytest.approx(6.5 / 8 * eight / 67e12, rel=1e-12)
    # A segment of 5 frames on a 4-slot memory: 0 + 1 + 2 + 3 + 4 slots.
    small = route({"traffic": {"segment_frames": 5}, "reference_args": {"memory_capacity": 4}})
    assert small.memory_reads()[0] == 2.0


def test_roofline_readers_read_the_counts():
    r = route()
    traced = SimpleNamespace(frames=24, kernel_seconds=lambda marker: {"corr_patch": 0.1,
                                                                        "memory_read_kernel": 1.5}[marker])
    run = SimpleNamespace(route=r)
    k3 = counts.least_seconds(*patch_lookup.k3_per_frame(r))
    assert SPEC.metric_module("k3_roofline").read(run, traced) == pytest.approx(100.0 * k3 * 24 / 0.1, rel=1e-12)
    k9 = memory_read.k9_seconds_per_frame(r)
    assert SPEC.metric_module("k9_roofline").read(run, traced) == pytest.approx(100.0 * k9 * 24 / 1.5, rel=1e-12)


@pytest.mark.parametrize("name", ["step_mfu_pct", "k2_roofline", "k3_roofline", "k9_roofline"])
def test_a_route_without_counts_gets_no_reading(name):
    run = SimpleNamespace(route=object())
    traced = SimpleNamespace(frames=4, wall_s=1.0, kernel_seconds=lambda marker: 0.5)
    assert SPEC.metric_module(name).read(run, traced) is None
