"""What a run's check has to catch, planted in a run after its set-up and
before its warm-up (`harness.run_cell(..., patch=...)`): each function takes
the run and its route and changes what the timed path delivers.  The
benchmark's own runs never plant anything; flowbench/calibrate.py reads
them on the card at the cell's size, and flowbench/tests at a CPU size.

- `fp8_control`: the lower-precision control, the plain reference in fp8
  (reference/control.py) put in the program's place: the window streams
  every segment through it instead of the engine.
- `memory_unchanged`: each step hands back the memory it was given, so the
  memory stays empty.
- `flow_altered`: each step's flow is moved by 16 px over a 16 x 16 block
  where it is produced.
"""

from __future__ import annotations

from .reference import control, plain


def fp8_control(run, route) -> None:
    from .harness import NoTF32

    model = control.to_fp8(run.reference(route.ref_state))

    def stream_flows(frames, warm_start=False):
        with NoTF32():
            return plain.memflow_replay(model, frames, len(frames) - 1, run.device)

    run.engine.stream_flows = stream_flows


def _wrap_forward(run, change) -> None:
    model = run.engine.model
    orig = model.forward

    def forward(pair, memory, flow_init=None):
        return change(orig(pair, memory, flow_init), memory)

    model.forward = forward


def memory_unchanged(run, route) -> None:
    _wrap_forward(run, lambda out, memory: (out[0], memory) + tuple(out[2:]))


def flow_altered(run, route) -> None:
    def alter(out, memory):
        flow = out[0].clone()
        flow[:, 32:48, 32:48, :] += 16.0
        return (flow,) + tuple(out[1:])

    _wrap_forward(run, alter)


PLANTED = {"control": fp8_control, "memory_unchanged": memory_unchanged, "flow_altered": flow_altered}
