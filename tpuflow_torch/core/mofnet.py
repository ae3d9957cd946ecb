"""MOFNet: VideoFlow's multi-frame optical flow net (port of
tpuflow/core/mofnet.py).

Call with frames [B, T, H, W, 3] in [0, 1] (T >= 3); returns (flows_fwd,
flows_bwd), each [B, T-2, H, W, 2], for the interior frames.

- fnet / cnet: Twins-SVT or the cnn BasicEncoder (instance norm for fnet,
  the 'batch' stand-in for cnet) to 1/8 resolution (core/encoders.py).
- att: GMA q/k over the context, once per window (core/gma.py).
- Two correlation objects per window, interior frame against its next and
  its previous frame (core/corr.py `make_corr`: a dense pyramid with kernel
  K1 up to 168x168 feature grids, FlashCorr2 with kernel K3 above; other
  formulations by `corr_impl`).
- `refine`: decoder_depth steps of the joint bidirectional SK update
  (core/sk.py; GMA apply = kernel K2) with the 48-channel motion hidden
  state shifted across interior frames, then the convex 8x upsample with
  the last step's mask.

Refinement starts the motion hidden state from the update block's
learned `init_hidden_state`, as upstream VideoFlow does (the motion encoder
expands it at the first step).  The JAX package starts it at zeros
(tpuflow/core/mofnet.py:482): the port departs from it there.

The stride-1 engine's pair-cached loop builds each frame pair's
correlation once (`pair_corr_state`) and refines from per-frame context and
per-pair correlations (`refine_pairs`): the lookup then runs per interior
frame on its own pair and re-interleaves in (window, interior) order.
BOFNet is MOFNet under another name, run at the config's T (3: one
interior frame).

Under runtime/sharding.py `shard_spatial_forward`, `forward` runs on one
row strip of the frames (core/strips.py): the encoders' and the update
block's cross-row operations exchange rows with the other strips, each
strip correlates its own queries against the whole frame's target features
(decided on the whole grid, looked up from the strip's first row), GMA
attends from its queries to the whole frame's keys, and the flows come out
in the strip's rows.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn

from ..runtime.profiling import span
from . import strips
from .corr import DENSE_LOOKUP_IMPLS, MATERIALIZE_THRESHOLD, DenseCorrPyramid, make_corr
from .encoders import make_encoder
from .gma import GMA_IMPLS, Attention, materialize_attention
from .sk import SKUpdateBlockMOF
from .update import upsample_flow_convex


class MOFEncoded(NamedTuple):
    """What `refine` consumes: context, GMA q/k and both correlation
    objects (anything with `.lookup(flow, radius)`)."""

    inp: torch.Tensor        # [B*N, h, w, 128] context
    net: torch.Tensor        # [B*N, h, w, 128] initial hidden state
    q: torch.Tensor          # [B*N, h, w, 128]
    k: torch.Tensor          # [B*N, h, w, 128]
    corr_fwd: Any            # one object, or a tuple of N per-pair objects
    corr_bwd: Any
    batch: int               # B: windows in the batch


# Frames per encoder call: as many as fit this many pixels (one 1920x1080
# frame, two 960x1080 tiles).  The Twins global attention materializes f32
# scores of (H/4 * W/4) queries x (H/32 * W/32) keys per head and frame.
ENCODER_CHUNK_PIXELS = 2**21
# The correlation objects' build (the dense pyramid's GEMMs and pooling, or
# FlashCorr2's pooled features).
CORR_SPAN = span("tpuflow.mof.corr")


def encode_chunked(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`net` over frames [M, H, W, 3], ENCODER_CHUNK_PIXELS at a time (both
    encoders are per frame, so chunking changes no value), counted on the
    whole frame: every strip of a sharded call chunks alike."""
    per = max(1, ENCODER_CHUNK_PIXELS // (strips.global_rows(x.shape[1]) * x.shape[2]))
    if x.shape[0] <= per:
        return net(x)
    return torch.cat([net(x[i : i + per]) for i in range(0, x.shape[0], per)])


class MOFNet(nn.Module):
    def __init__(
        self,
        corr_levels: int = 4,
        corr_radius: int = 4,
        decoder_depth: int = 12,
        feature_dim: int = 256,
        hidden_dim: int = 128,
        context_dim: int = 128,
        encoder: str = "twins",
        corr_dtype: torch.dtype = torch.bfloat16,
        corr_impl: str = "auto",
        dense_lookup: str = "auto",
        gma_impl: str = "auto",
        attn_mem_budget: int = 3 * 10**9,
    ):
        """`corr_impl`: see core/corr.py `make_corr`.  `dense_lookup`: the
        lookup of a DenseCorrPyramid, 'auto' (kernel K1), 'patch' (kernel
        K4 + epilogue) or 'xla' (plain torch, differentiable).  `gma_impl`:
        GMA's apply, 'auto' or 'flash' (kernel K2) or 'xla' (plain torch;
        the probabilities are materialized once per window in `refine` when
        the [B*N, hw, hw] bf16 matrix takes at most `attn_mem_budget` bytes,
        as tpuflow/core/mofnet.py:465-478).  The train step needs 'xla' for
        both: the kernels refuse a gradient."""
        super().__init__()
        if dense_lookup not in DENSE_LOOKUP_IMPLS:
            raise ValueError(f"dense_lookup {dense_lookup!r}: expected one of {DENSE_LOOKUP_IMPLS}")
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.decoder_depth = decoder_depth
        self.feature_dim = feature_dim
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.corr_dtype = corr_dtype  # cost-volume storage dtype
        self.corr_impl = corr_impl
        self.dense_lookup = dense_lookup
        # Largest feature grid 'auto' materializes (make_corr); parity runs
        # lower it to reach the large-grid formulation on a small frame.
        self.materialize_threshold = MATERIALIZE_THRESHOLD
        self.fnet = make_encoder(encoder, feature_dim, "instance")
        self.cnet = make_encoder(encoder, hidden_dim + context_dim, "batch")
        self.att = Attention(dim=context_dim, dim_head=context_dim)
        self.update_block = SKUpdateBlockMOF(corr_levels, corr_radius, hidden_dim, context_dim=context_dim)
        self.gma_impl = gma_impl
        self.attn_mem_budget = attn_mem_budget

    @property
    def dtype(self) -> torch.dtype:
        return self.att.to_qk.weight.dtype

    @property
    def gma_impl(self) -> str:
        return self.update_block.aggregator.impl

    @gma_impl.setter
    def gma_impl(self, impl: str) -> None:
        if impl not in GMA_IMPLS:
            raise ValueError(f"gma_impl {impl!r}: expected one of {GMA_IMPLS}")
        self.update_block.aggregator.impl = impl

    @span("tpuflow.mof.encode")
    def frame_features(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, H, W, 3] in [0, 1] -> (fnet features [M, H/8, W/8, 256], cnet
        context [M, H/8, W/8, 256]).  Both encoders are per frame, so the
        stride-1 engine computes them once per frame."""
        x = (2.0 * frames - 1.0).to(self.dtype)
        return encode_chunked(self.fnet, x), encode_chunked(self.cnet, x)

    def prepare_context(self, ctx: torch.Tensor):
        """Per-frame context [M, h, w, 256] -> (net, inp, q, k)."""
        net = torch.tanh(ctx[..., : self.hidden_dim])
        inp = torch.relu(ctx[..., self.hidden_dim :])
        q, k = self.att(inp)
        return net, inp, q, k

    def encode_from_features(self, feats: torch.Tensor, ctx: torch.Tensor) -> MOFEncoded:
        """Window assembly from per-frame features: feats [B, T, h, w, Cf],
        ctx [B, T, h, w, 256] (interiors 1..T-2 of ctx are read).  In a strip
        the targets are the whole frame's, gathered from every strip."""
        b, t, h8, w8 = feats.shape[:4]
        n = t - 2
        net, inp, q, k = self.prepare_context(ctx[:, 1 : t - 1].reshape(b * n, h8, w8, -1))
        center = feats[:, 1 : t - 1].reshape(b * n, h8, w8, -1).to(self.corr_dtype)
        strip = strips.current()
        targets = feats if strip is None else strip.gather(feats, 2)
        fwd_tgt = targets[:, 2:t].reshape(b * n, -1, w8, targets.shape[-1]).to(self.corr_dtype)
        bwd_tgt = targets[:, 0 : t - 2].reshape(b * n, -1, w8, targets.shape[-1]).to(self.corr_dtype)
        kw = dict(impl=self.corr_impl, materialize_threshold=self.materialize_threshold,
                  row0=strips.first_row(h8))
        with CORR_SPAN:
            corr_fwd = make_corr(center, fwd_tgt, self.corr_levels, **kw)
            corr_bwd = make_corr(center, bwd_tgt, self.corr_levels, **kw)
        return MOFEncoded(inp, net, q, k, corr_fwd, corr_bwd, b)

    @CORR_SPAN
    def pair_corr_state(self, center: torch.Tensor, target: torch.Tensor):
        """The correlation object of one (center, target) frame pair, each
        [M, h, w, Cf]: it depends on the pair only, so the stride-1 loop
        builds it once for every window the pair appears in."""
        return make_corr(
            center.to(self.corr_dtype), target.to(self.corr_dtype), self.corr_levels,
            impl=self.corr_impl, materialize_threshold=self.materialize_threshold,
        )

    def refine_pairs(self, prepared: Sequence, corr_fwd: Sequence, corr_bwd: Sequence):
        """`refine` from per-frame prepared context (N interior frames of
        (net, inp, q, k) as `prepare_context` returns them, each [M, h, w,
        .]) and per-pair correlation objects (N per direction).  The context
        stacks in (window, interior) order, as encode_from_features
        reshapes it."""
        n, m = len(prepared), prepared[0][0].shape[0]

        def stack(i):
            return torch.stack([p[i] for p in prepared], dim=1).reshape(m * n, *prepared[0][i].shape[1:])

        enc = MOFEncoded(stack(1), stack(0), stack(2), stack(3), tuple(corr_fwd), tuple(corr_bwd), m)
        return self.refine(enc)

    @span("tpuflow.mof.encode")
    def encode(self, frames: torch.Tensor) -> MOFEncoded:
        """frames [B, T, H, W, 3] in [0, 1] -> the encoded window state (cnet
        runs on the interior frames only)."""
        b, t, h, w, _ = frames.shape
        if t < 3:
            raise ValueError("MOFNet needs at least 3 frames")
        n = t - 2
        x = (2.0 * frames - 1.0).to(self.dtype)
        feats = encode_chunked(self.fnet, x.reshape(b * t, h, w, 3))
        feats = feats.reshape(b, t, *feats.shape[1:])
        ctx_i = encode_chunked(self.cnet, x[:, 1 : t - 1].reshape(b * n, h, w, 3))
        ctx_i = ctx_i.reshape(b, n, *ctx_i.shape[1:])
        pad = torch.zeros_like(ctx_i[:, :1])
        return self.encode_from_features(feats, torch.cat([pad, ctx_i, pad], dim=1))

    def _lookup(self, corr, flow: torch.Tensor) -> torch.Tensor:
        if isinstance(corr, tuple):
            # Per-pair objects: interior j's queries go to pair j, and the
            # features re-interleave to the (window, interior) batch order.
            bn, h8, w8, _ = flow.shape
            f = flow.reshape(bn // len(corr), len(corr), h8, w8, 2)
            outs = [self._lookup(c, f[:, j].contiguous()) for j, c in enumerate(corr)]
            return torch.stack(outs, dim=1).reshape(bn, h8, w8, -1)
        if isinstance(corr, DenseCorrPyramid):
            return corr.lookup(flow, self.corr_radius, impl=self.dense_lookup)
        return corr.lookup(flow, self.corr_radius)

    @span("tpuflow.mof.refine")
    def refine(self, enc: MOFEncoded) -> Tuple[torch.Tensor, torch.Tensor]:
        """Iterative refinement + convex upsample -> ([B, N, H, W, 2],) x 2.
        In a strip, GMA's keys are the whole frame's (gathered once here),
        and the materialization budget is judged on the strip's queries."""
        bn, h8, w8, _ = enc.net.shape
        b = enc.batch
        n = bn // b
        flow = torch.zeros((bn, h8, w8, 4), dtype=torch.float32, device=enc.net.device)
        net = enc.net
        mhs = None          # the motion encoder expands the learned init
        strip = strips.current()
        k = enc.k if strip is None else strip.gather(enc.k, 1)
        attn = None
        if self.gma_impl == "xla" and bn * h8 * w8 * k.shape[1] * w8 * 2 <= self.attn_mem_budget:
            attn = materialize_attention(enc.q, k, self.dtype)
        for _ in range(self.decoder_depth):
            cf = self._lookup(enc.corr_fwd, flow[..., 0:2]).to(self.dtype)
            cb = self._lookup(enc.corr_bwd, flow[..., 2:4]).to(self.dtype)
            corr = torch.cat([cf, cb], dim=-1)
            net, mhs, delta = self.update_block.step(net, mhs, enc.inp, corr, flow, enc.q, k, b, attn)
            flow = flow + delta.float()
        # Only the last step's mask is read, so the mask head runs once.
        mask = self.update_block.upsample_mask(net).float()
        up_fwd = upsample_flow_convex(flow[..., 0:2], mask[..., : 64 * 9])
        up_bwd = upsample_flow_convex(flow[..., 2:4], mask[..., 64 * 9 :])
        h, w = 8 * h8, 8 * w8
        return up_fwd.reshape(b, n, h, w, 2), up_bwd.reshape(b, n, h, w, 2)

    def forward(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.refine(self.encode(frames))


class BOFNet(MOFNet):
    """VideoFlow's bi-directional variant (CLI `--vf-architecture bof`): the
    MOFNet machinery, run at the config's T; at T = 3 one interior frame,
    whose forward and backward flows come back (tpuflow/core/mofnet.py:508)."""
