#!/usr/bin/env python3
"""What the check of a MOF cell has to catch, planted as faults.py plants
MemFlow's (each function takes the run and its route, after set-up and
before the warm-up, and changes what the timed path delivers).  The plants
drive both MOF routes: the tiled cell, mof-tiled-stride1-1080p
(`compute_flows_tiled_stride1`), and the untiled one, mof-untiled-1080p
(`compute_flow_batch`, one centred window of whole frames a frame).

- `control`: the lower-precision control, the plain reference in fp8
  (reference/control.py) put in the program's place: each frame that the
  route asks the engine for computed by the route's own `reference_flow`
  from its centred window, as the check computes it (tile by tile on the
  tiled route, over whole frames on the untiled one), instead of the
  engine's entry.
- `zero_start`: the refinement's motion hidden state started from zeros,
  not from the learned `init_hidden_state`.
- `flow_altered`: each window's forward flows moved by 16 px over a 16 x 16
  block where the refinement produces them.

Run as a script, it reads a cell's limits with these plants added to
faults.py's (its `control` and `flow_altered` in place of MemFlow's), in
one process on the card:

    python3 flowbench/faults_mof.py --workload mof-tiled-stride1-1080p --seeds 30 \\
        --planted control:3,zero_start:3,flow_altered:1
    python3 flowbench/faults_mof.py --workload mof-untiled-1080p --seeds 30 \\
        --planted control:3,zero_start:3,flow_altered:1
"""

from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    # The repository's root, in place of this directory (as run.py).
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flowbench.reference import control  # noqa: E402


def fp8_control(run, route) -> None:
    from flowbench.harness import NoTF32

    model = control.to_fp8(run.reference(route.ref_state))

    def flows(frames, indices):
        with NoTF32():
            return np.stack([route.reference_flow(model, frames, i) for i in indices])

    def compute_flows_tiled_stride1(frames, tile_size=None, window_batch=1):
        return flows(frames, range(len(frames)))

    def compute_flow_batch(frames, frame_indices):
        return flows(frames, frame_indices)

    run.engine.compute_flows_tiled_stride1 = compute_flows_tiled_stride1
    run.engine.compute_flow_batch = compute_flow_batch


def zero_start(run, route) -> None:
    enc = run.engine.model.update_block.encoder
    orig = enc.forward

    def forward(flow, mhs, corr, bs):
        if mhs is None:
            bn, h, w, _ = flow.shape
            mhs = torch.zeros((bs, bn // bs, h, w, enc.hidden_ch), dtype=corr.dtype, device=corr.device)
        return orig(flow, mhs, corr, bs)

    enc.forward = forward


def flow_altered(run, route) -> None:
    model = run.engine.model
    orig = model.refine

    def refine(enc):
        up_fwd, up_bwd = orig(enc)
        up_fwd = up_fwd.clone()
        up_fwd[:, :, 32:48, 32:48, :] += 16.0
        return up_fwd, up_bwd

    model.refine = refine


PLANTED = {"control": fp8_control, "zero_start": zero_start, "flow_altered": flow_altered}


if __name__ == "__main__":
    from flowbench import calibrate, faults

    faults.PLANTED.update(PLANTED)
    sys.exit(calibrate.main())
