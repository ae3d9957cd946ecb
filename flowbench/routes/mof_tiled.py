"""VideoFlow MOF, tiled stride-1: FlowEngine.compute_flows_tiled_stride1 on
whole segments of the traffic, as the CLI's --tile runs the default model.
Unit: a segment.

The tiling is the balanced layout, worked out here from the frame and the
cell's `tile_size`: per axis ceil(n / tile_size) tiles of one size,
ceil(n / k) rounded up to a multiple of 8, spread evenly with the last one
at the edge; flows pasted hard, later tiles over earlier ones."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import traffic
from ..models import program_engine, reference_model
from ..reference import plain


def _axis(n: int, size: int):
    k = math.ceil(n / size)
    if k <= 1:
        return n, [0]
    t = min(n, math.ceil(math.ceil(n / k) / 8) * 8)
    return t, [round(i * (n - t) / (k - 1)) for i in range(k)]


def centred_window(n: int, i: int, length: int):
    """Frame indices of frame i's centred window, the ends repeated."""
    start, end = max(0, i - length // 2), min(n, i + length // 2 + 1)
    seq = list(range(start, end))
    while len(seq) < length:
        seq = [seq[0]] + seq if start == 0 else seq + [seq[-1]]
    return seq


class _Given(torch.nn.Module):
    """An encoder whose features are already computed: features of
    `feats`' shape for each image it is handed, at no cost."""

    def __init__(self, feats):
        super().__init__()
        self.feats = feats

    def forward(self, x):
        return self.feats.new_zeros(x.shape[0], *self.feats.shape[1:])


class Route:
    RATE = "frames_per_s"

    def __init__(self, run):
        self.run = run

    def tiling(self):
        """(tile height, tile width, [(y, x), ...])."""
        size = self.run.cell["tile_size"]
        th, ys = _axis(self.run.traffic["height"], size)
        tw, xs = _axis(self.run.traffic["width"], size)
        return th, tw, [(y, x) for y in ys for x in xs]

    def _grid(self):
        """(rows of queries per window: tiles x interior frames, tokens of a
        tile's 1/8 grid)."""
        th, tw, tiles = self.tiling()
        rows = len(tiles) * (self.run.config["model_config"]["sequence_length"] - 2)
        return rows, math.ceil(th / 8) * math.ceil(tw / 8)

    def reference_frame(self, device):
        """One delivered frame's work (counts): what the stride-1 path does
        for it, in the reference's terms.  Both encoders on one frame's
        tiles (the path's cache encodes each frame once), then one window
        of T frames of every tile through the rest of the MOF reference
        (GMA's attention, the two dense pyramids' build, the refinement and
        the upsample), its encoders handed features without computing."""
        model = reference_model(self.run.config, device)
        th, tw, tiles = self.tiling()
        t = self.run.config["model_config"]["sequence_length"]
        shape = (len(tiles), 3, th + (-th) % 8, tw + (-tw) % 8)
        frame = torch.zeros(shape, device=device)
        window = torch.zeros(shape[0], t, *shape[1:], device=device)
        fnet, cnet = model.fnet, model.cnet

        def work():
            feats = fnet(frame)
            cnet(frame)
            model.fnet = model.cnet = _Given(feats)
            return model(window)

        return work
    def aggregation(self):
        """GMA's aggregation per delivered frame (counts): a row for each
        tile and interior frame of the window, over the tile's 1/8 grid."""
        mc = self.run.config["model_config"]
        rows, tokens = self._grid()
        return rows, tokens, mc["context_dim"], mc["decoder_depth"]

    def lookups(self):
        """The dense pyramids' lookups per delivered frame (counts: K1's
        work), as (launches, queries a launch, levels, radius): one lookup a
        direction and iteration over every tile's and interior frame's 1/8
        grid.  A tile's grid lies under the 168 x 168 cells up to which the
        'auto' correlation materializes its volumes."""
        mc = self.run.config["model_config"]
        rows, tokens = self._grid()
        return 2 * mc["decoder_depth"], rows * tokens, mc["corr_levels"], mc["corr_radius"]

    def setup(self) -> None:
        run = self.run
        sd, self.ref_state = run.draw_weights()
        run.engine = program_engine(run.config, sd, run.device)
        tp = run.traffic
        self.segments = [traffic.segment(tp, run.seed, k, run.device) for k in range(tp["segments"])]

    def _flows(self, frames):
        cell = self.run.cell
        return self.run.engine.compute_flows_tiled_stride1(
            frames, tile_size=cell["tile_size"], window_batch=cell["window_batch"])

    def warmup(self) -> None:
        self._flows(self.segments[0][: self.run.cell["warmup_frames"]])

    def window(self, window, tracer) -> None:
        self.delivered = []
        k = 0
        while not window.closed:
            s = k % len(self.segments)
            seg = self.segments[s]
            out = []

            def call(seg=seg, out=out):
                out.append(self._flows(seg))
                return len(seg)

            window.open()
            tracer.call(call, k)
            if window.done(len(seg)):
                self.delivered.append((s, out[0]))
            k += 1

    def release(self) -> None:
        pass

    @torch.no_grad()
    def reference_flow(self, model, frames, i: int) -> np.ndarray:
        """Frame i's forward flow [H, W, 2] by `model` (the reference, or a
        stand-in with its call) from its centred window, tile by tile, each
        tile edge-padded to a multiple of 8, the tiles pasted in order."""
        n, h, w = frames.shape[:3]
        t = self.run.config["model_config"]["sequence_length"]
        th, tw, tiles = self.tiling()
        x = plain.to_unit(frames[centred_window(n, i, t)], self.run.device)
        out = np.zeros((h, w, 2), np.float32)
        for y, c in tiles:
            padded, (top, left) = plain.pad8(x[:, :, y : y + th, c : c + tw])
            up_fwd, _ = model(padded[None])
            tile = up_fwd[0, (t - 2) // 2, :, top : top + th, left : left + tw]
            out[y : y + th, c : c + tw] = tile.permute(1, 2, 0).cpu().numpy()
        return out

    def check(self, window) -> dict:
        """A delivered segment drawn from the seed and `check_frames` of its
        frames drawn from the seed, each recomputed by the reference from
        its centred window, tile by tile, and pasted."""
        run = self.run
        rng = np.random.default_rng(run.seed)
        s, flows = self.delivered[int(rng.integers(len(self.delivered)))]
        frames = self.segments[s]
        n = len(frames)
        model = run.reference(self.ref_state)
        self.frame_gaps = []
        for i in sorted(rng.choice(n, size=min(n, run.cell["check_frames"]), replace=False)):
            ref = self.reference_flow(model, frames, int(i))
            self.frame_gaps.append(plain.flow_gaps(flows[i], ref))
        return {"flow_epe_px": max(g[0] for g in self.frame_gaps),
                "flow_epe_max_px": max(g[1] for g in self.frame_gaps)}
