"""VideoFlow MOF untiled: FlowEngine.compute_flow_batch(segment, [i]) for every
frame i of whole segments of the traffic, in order, as the CLI runs the
default model without --tile (tools/pipeline.py at its default
batch_frames of 1): one centred window of T whole frames a frame, the ends
repeated, each window encoded anew.  Unit: a segment."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import traffic
from ..models import program_engine, reference_model
from ..reference import plain
from .mof_tiled import _Given, centred_window


class Route:
    RATE = "frames_per_s"

    def __init__(self, run):
        self.run = run

    def _grid(self):
        """(rows of queries per window: its interior frames, tokens of a
        whole frame's 1/8 grid)."""
        tp = self.run.traffic
        rows = self.run.config["model_config"]["sequence_length"] - 2
        return rows, math.ceil(tp["height"] / 8) * math.ceil(tp["width"] / 8)

    def reference_frame(self, device):
        """One delivered frame's work (counts), with features shared between
        windows: both encoders on one whole frame, then one window of T
        whole frames through the rest of the MOF reference (GMA's attention,
        both all-pairs pyramids, the refinement and the upsample), its
        encoders handed features without computing.  The path itself
        encodes every frame of every window (fnet on T frames, cnet on the
        T - 2 interior ones); that repeated work is not counted as model
        work, so step_mfu_pct reads the same model's work as in the tiled
        cell."""
        model = reference_model(self.run.config, device)
        h, w = self.run.traffic["height"], self.run.traffic["width"]
        t = self.run.config["model_config"]["sequence_length"]
        frame = torch.zeros(1, 3, h + (-h) % 8, w + (-w) % 8, device=device)
        window = torch.zeros(1, t, *frame.shape[1:], device=device)

        def work():
            feats = model.fnet(frame)
            model.cnet(frame)
            model.fnet = model.cnet = _Given(feats)
            return model(window)

        return work

    def aggregation(self):
        """GMA's aggregation per delivered frame (counts): a row for each
        interior frame of the window, over the whole frame's 1/8 grid."""
        mc = self.run.config["model_config"]
        rows, tokens = self._grid()
        return rows, tokens, mc["context_dim"], mc["decoder_depth"]

    def patch_lookups(self):
        """FlashCorr2's lookups per delivered frame (counts: K3's work), as
        (lookups, queries a lookup, levels, radius, channels): one lookup a
        direction and iteration over every interior frame's 1/8 grid.  A
        whole frame's grid lies above the 168 x 168 cells up to which the
        'auto' correlation materializes its volumes."""
        mc = self.run.config["model_config"]
        rows, tokens = self._grid()
        return 2 * mc["decoder_depth"], rows * tokens, mc["corr_levels"], mc["corr_radius"], mc["feature_dim"]

    def setup(self) -> None:
        run = self.run
        sd, self.ref_state = run.draw_weights()
        run.engine = program_engine(run.config, sd, run.device)
        tp = run.traffic
        self.segments = [traffic.segment(tp, run.seed, k, run.device) for k in range(tp["segments"])]

    def _flow(self, frames, i: int) -> np.ndarray:
        return self.run.engine.compute_flow_batch(frames, [i])[0]

    def warmup(self) -> None:
        seg = self.segments[0]
        for i in range(self.run.cell["warmup_frames"]):
            self._flow(seg, i)

    def window(self, window, tracer) -> None:
        self.delivered = []
        k = 0
        while not window.closed:
            s = k % len(self.segments)
            seg = self.segments[s]
            out = []

            def call(seg=seg, out=out):
                out.extend(self._flow(seg, i) for i in range(len(seg)))
                return len(seg)

            window.open()
            tracer.call(call, k)
            if window.done(len(seg)):
                self.delivered.append((s, out))
            k += 1

    def release(self) -> None:
        pass

    @torch.no_grad()
    def reference_flow(self, model, frames, i: int) -> np.ndarray:
        """Frame i's forward flow [H, W, 2] by `model` (the reference, or a
        stand-in with its call) from its centred window of whole frames,
        edge-padded to a multiple of 8."""
        n, h, w = frames.shape[:3]
        t = self.run.config["model_config"]["sequence_length"]
        x = plain.to_unit(frames[centred_window(n, i, t)], self.run.device)
        padded, (top, left) = plain.pad8(x)
        up_fwd, _ = model(padded[None])
        flow = up_fwd[0, (t - 2) // 2, :, top : top + h, left : left + w]
        return flow.permute(1, 2, 0).cpu().numpy()

    def check(self, window) -> dict:
        """A delivered segment drawn from the seed and `check_frames` of its
        frames drawn from the seed, each recomputed by the reference from
        its centred window of whole frames.  Per frame: the mean and
        largest end-point gap, the reference's mean flow, and the share of
        outlier pixels (plain.flow_outlier_pct); each number's largest over
        the frames is returned, and the cell's limits say which are
        compared."""
        run = self.run
        rng = np.random.default_rng(run.seed)
        s, flows = self.delivered[int(rng.integers(len(self.delivered)))]
        frames = self.segments[s]
        n = len(frames)
        model = run.reference(self.ref_state)
        self.frame_gaps = []
        for i in sorted(rng.choice(n, size=min(n, run.cell["check_frames"]), replace=False)):
            ref = self.reference_flow(model, frames, int(i))
            self.frame_gaps.append(plain.flow_gaps(flows[i], ref) + (plain.flow_outlier_pct(flows[i], ref),))
        return {"flow_epe_px": max(g[0] for g in self.frame_gaps),
                "flow_epe_max_px": max(g[1] for g in self.frame_gaps),
                "flow_outlier_pct": max(g[3] for g in self.frame_gaps)}
