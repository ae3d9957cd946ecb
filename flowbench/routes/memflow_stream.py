"""MemFlow streaming: FlowEngine.stream_flows on whole segments of the
traffic, the memory carried within a segment and empty at its start, as the
CLI's --model memflow calls it.  Unit: a segment."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import traffic
from ..models import program_engine, reference_model
from ..reference import plain


class Route:
    RATE = "frames_per_s"

    def __init__(self, run):
        self.run = run

    def reference_frame(self, device):
        """One delivered frame's work (counts): one pair of padded frames
        through the MemFlow reference on an empty memory."""
        model = reference_model(self.run.config, device)
        h, w = self.run.traffic["height"], self.run.traffic["width"]
        ph, pw = h + (-h) % 8, w + (-w) % 8
        pair = torch.zeros(1, 2, 3, ph, pw, device=device)
        memory = model.empty_memory(1, ph, pw, device)
        return lambda: model(pair, memory)

    def aggregation(self):
        """GMA's aggregation per delivered frame (counts): one row of the
        1/8 grid's tokens at the configuration's width and depth."""
        mc = self.run.config["model_config"]
        h, w = self.run.traffic["height"], self.run.traffic["width"]
        return 1, math.ceil(h / 8) * math.ceil(w / 8), mc["context_dim"], mc["decoder_depth"]

    def patch_lookups(self):
        """FlashCorr2's lookups per delivered frame (counts: K3's work), as
        (lookups, queries a lookup, levels, radius, channels): one lookup an
        iteration over the frame's 1/8 grid, which lies above the 168 x 168
        cells up to which the 'auto' correlation materializes its volume."""
        mc = self.run.config["model_config"]
        _, tokens, _, depth = self.aggregation()
        return depth, tokens, mc["corr_levels"], mc["corr_radius"], mc["feature_dim"]

    def memory_reads(self):
        """The memory's readout per delivered frame (counts: K9's work), as
        (valid slots read, queries, keys a slot, dk, dv): frame i of a
        segment reads min(i, capacity) slots (the memory is empty at a
        segment's start), averaged over the segment's frames (6.5 at 24
        frames and 8 slots); one query and one key a cell of the 1/8 grid."""
        ra = self.run.config["reference_args"]
        n = self.run.traffic["segment_frames"]
        slots = sum(min(i, ra["memory_capacity"]) for i in range(n)) / n
        _, tokens, _, _ = self.aggregation()
        return slots, tokens, tokens, ra["key_dim"], ra["value_dim"]

    def setup(self) -> None:
        run = self.run
        sd, self.ref_state = run.draw_weights()
        run.engine = program_engine(run.config, sd, run.device)
        tp = run.traffic
        self.segments = [traffic.segment(tp, run.seed, k, run.device) for k in range(tp["segments"])]

    def warmup(self) -> None:
        self.run.engine.stream_flows(self.segments[0][: self.run.cell["warmup_frames"]])

    def window(self, window, tracer) -> None:
        self.delivered = []
        k = 0
        while not window.closed:
            s = k % len(self.segments)
            seg = self.segments[s]
            out = []

            def call(seg=seg, out=out):
                out.append(self.run.engine.stream_flows(seg))
                return len(seg)

            window.open()
            tracer.call(call, k)
            if window.done(len(seg)):
                self.delivered.append((s, out[0]))
            k += 1

    def release(self) -> None:
        pass

    def check(self, window) -> dict:
        """One delivered segment drawn from the seed, replayed by the
        reference from its first frame up to a frame drawn from the seed
        past the memory's capacity (so the ring has wrapped); every flow of
        the replay against the delivered one."""
        run = self.run
        rng = np.random.default_rng(run.seed)
        s, flows = self.delivered[int(rng.integers(len(self.delivered)))]
        cap = run.config["reference_args"]["memory_capacity"]
        upto = min(len(flows) - 1, cap + 1 + int(rng.integers(run.cell["check_past_capacity"])))
        ref = plain.memflow_replay(run.reference(self.ref_state), self.segments[s], upto, run.device)
        self.frame_gaps = [plain.flow_gaps(flows[j], ref[j]) for j in range(upto + 1)]
        return {"flow_epe_px": max(g[0] for g in self.frame_gaps),
                "flow_epe_max_px": max(g[1] for g in self.frame_gaps)}
