"""The plain reference against the program on the CPU at a small size in
float32, on one state dict drawn as a run draws it: MemFlow streamed past
its memory's capacity."""

from flowbench import harness, spec as spec_mod, traffic
from flowbench.models import program_engine
from flowbench.reference import plain
from flowbench.tests import small

# Shares of the reference's mean flow.  float32 on both sides: the lookups'
# arithmetic differs between the program's plain versions and grid_sample
# by ~1e-5 of a correlation value, which the sensitive random weights of
# weights.py carry to ~1e-3 of the mean flow over two iterations.
MEAN_TOL, MAX_TOL = 3e-3, 2e-2


def setup(cell, overrides, seed):
    run = harness.Run(cell, seed, 1, False, "cpu", 0.0, spec_mod.Spec(), overrides)
    sd, ref_state = run.draw_weights()
    return run, sd, ref_state, traffic.segment(run.traffic, seed, 0, "cpu")


def test_memflow_stream_matches_reference_past_capacity():
    run, sd, ref_state, seg = setup("memflow-stream-1080p", small.memflow(10), 2**31 + 3)
    assert len(seg) > run.config["reference_args"]["memory_capacity"] + 1
    got = program_engine(run.config, sd, "cpu").stream_flows(seg)
    ref = plain.memflow_replay(run.reference(ref_state), seg, len(seg) - 1, "cpu")
    for j in range(len(seg)):
        mean, mx, scale = plain.flow_gaps(got[j], ref[j])
        assert mean < MEAN_TOL * scale and mx < MAX_TOL * scale, (j, mean, mx, scale)
