"""MOFNet: VideoFlow's multi-frame optical flow net (port of
tpuflow/core/mofnet.py).

Call with frames [B, T, H, W, 3] in [0, 1] (T >= 3); returns (flows_fwd,
flows_bwd), each [B, T-2, H, W, 2], for the interior frames.

- fnet / cnet: Twins-SVT to 1/8 resolution (core/encoders.py).
- att: GMA q/k over the context, once per window (core/gma.py).
- Two dense correlation pyramids per window, interior frame against its
  next and its previous frame (core/corr.py; lookup = kernel K1).
- `refine`: decoder_depth steps of the joint bidirectional SK update
  (core/sk.py; GMA apply = kernel K2) with the 48-channel motion hidden
  state shifted across interior frames, then the convex 8x upsample with
  the last step's mask.

Like the JAX reference, refinement starts the motion hidden state at
zeros (mofnet.py:482); the learned `init_hidden_state` is loaded but not
read on this path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

from .corr import DenseCorrPyramid, make_corr
from .encoders import make_encoder
from .gma import Attention
from .sk import SKUpdateBlockMOF
from .update import upsample_flow_convex


class MOFEncoded(NamedTuple):
    """What `refine` consumes: context, GMA q/k and both pyramids."""

    inp: torch.Tensor        # [B*N, h, w, 128] context
    net: torch.Tensor        # [B*N, h, w, 128] initial hidden state
    q: torch.Tensor          # [B*N, h, w, 128]
    k: torch.Tensor          # [B*N, h, w, 128]
    corr_fwd: DenseCorrPyramid
    corr_bwd: DenseCorrPyramid
    batch: int               # B: windows in the batch


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
    ):
        super().__init__()
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.decoder_depth = decoder_depth
        self.feature_dim = feature_dim
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.corr_dtype = corr_dtype  # cost-volume storage dtype
        self.corr_impl = corr_impl
        self.fnet = make_encoder(encoder, feature_dim)
        self.cnet = make_encoder(encoder, hidden_dim + context_dim)
        self.att = Attention(dim=context_dim, dim_head=context_dim)
        self.update_block = SKUpdateBlockMOF(corr_levels, corr_radius, hidden_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.att.to_qk.weight.dtype

    def frame_features(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, H, W, 3] in [0, 1] -> (fnet features [M, H/8, W/8, 256], cnet
        context [M, H/8, W/8, 256]).  Both encoders are per frame, so the
        stride-1 engine computes them once per frame."""
        x = (2.0 * frames - 1.0).to(self.dtype)
        return self.fnet(x), self.cnet(x)

    def prepare_context(self, ctx: torch.Tensor):
        """Per-frame context [M, h, w, 256] -> (net, inp, q, k)."""
        net = torch.tanh(ctx[..., : self.hidden_dim])
        inp = torch.relu(ctx[..., self.hidden_dim :])
        q, k = self.att(inp)
        return net, inp, q, k

    def encode_from_features(self, feats: torch.Tensor, ctx: torch.Tensor) -> MOFEncoded:
        """Window assembly from per-frame features: feats [B, T, h, w, Cf],
        ctx [B, T, h, w, 256] (interiors 1..T-2 of ctx are read)."""
        b, t, h8, w8 = feats.shape[:4]
        n = t - 2
        net, inp, q, k = self.prepare_context(ctx[:, 1 : t - 1].reshape(b * n, h8, w8, -1))
        center = feats[:, 1 : t - 1].reshape(b * n, h8, w8, -1).to(self.corr_dtype)
        fwd_tgt = feats[:, 2:t].reshape(b * n, h8, w8, -1).to(self.corr_dtype)
        bwd_tgt = feats[:, 0 : t - 2].reshape(b * n, h8, w8, -1).to(self.corr_dtype)
        corr_fwd = make_corr(center, fwd_tgt, self.corr_levels, self.corr_impl)
        corr_bwd = make_corr(center, bwd_tgt, self.corr_levels, self.corr_impl)
        return MOFEncoded(inp, net, q, k, corr_fwd, corr_bwd, b)

    def encode(self, frames: torch.Tensor) -> MOFEncoded:
        """frames [B, T, H, W, 3] in [0, 1] -> the encoded window state (cnet
        runs on the interior frames only)."""
        b, t, h, w, _ = frames.shape
        if t < 3:
            raise ValueError("MOFNet needs at least 3 frames")
        n = t - 2
        x = (2.0 * frames - 1.0).to(self.dtype)
        feats = self.fnet(x.reshape(b * t, h, w, 3))
        feats = feats.reshape(b, t, *feats.shape[1:])
        ctx_i = self.cnet(x[:, 1 : t - 1].reshape(b * n, h, w, 3))
        ctx_i = ctx_i.reshape(b, n, *ctx_i.shape[1:])
        pad = torch.zeros_like(ctx_i[:, :1])
        return self.encode_from_features(feats, torch.cat([pad, ctx_i, pad], dim=1))

    def refine(self, enc: MOFEncoded) -> Tuple[torch.Tensor, torch.Tensor]:
        """Iterative refinement + convex upsample -> ([B, N, H, W, 2],) x 2."""
        bn, h8, w8, _ = enc.net.shape
        b = enc.batch
        n = bn // b
        r = self.corr_radius
        flow = torch.zeros((bn, h8, w8, 4), dtype=torch.float32, device=enc.net.device)
        net = enc.net
        mhs = torch.zeros((b, n, h8, w8, 48), dtype=self.dtype, device=enc.net.device)
        for _ in range(self.decoder_depth):
            cf = enc.corr_fwd.lookup(flow[..., 0:2], r).to(self.dtype)
            cb = enc.corr_bwd.lookup(flow[..., 2:4], r).to(self.dtype)
            corr = torch.cat([cf, cb], dim=-1)
            net, mhs, delta = self.update_block.step(net, mhs, enc.inp, corr, flow, enc.q, enc.k, b)
            flow = flow + delta.float()
        # Only the last step's mask is read, so the mask head runs once.
        mask = self.update_block.upsample_mask(net).float()
        up_fwd = upsample_flow_convex(flow[..., 0:2], mask[..., : 64 * 9])
        up_bwd = upsample_flow_convex(flow[..., 2:4], mask[..., 64 * 9 :])
        h, w = 8 * h8, 8 * w8
        return up_fwd.reshape(b, n, h, w, 2), up_bwd.reshape(b, n, h, w, 2)

    def forward(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.refine(self.encode(frames))
