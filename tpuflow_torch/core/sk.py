"""SKFlow update blocks (port of tpuflow/core/sk.py): PCBlock4_Deep_nopool_res,
VideoFlow MOF's SKMotionEncoder6_Deep_nopool_res and
SKUpdateBlock6_Deep_nopoolres_AllDecoder2, and MemFlow's two-frame
SKMotionEncoderMem and SKUpdateBlockMem, under their upstream state-dict
names.  Tensors are NHWC throughout: the PCBlocks, both motion encoders
and both steps concatenate and split on the last axis.

PCBlock4's 1x1 convs run through kernel K8 (kernels/pointwise.py), a GEMM
on the NHWC rows with the bias, the residual add and the GELU in its
epilogue: five launches a block.  Its depthwise stages run through kernel
K7 (kernels/depthwise.py), one launch for each k > 1 entry with the k = 1
entry before it folded in.  Only the mask head's convs run on NCHW views.
In a spatially sharded call (core/strips.py) the depthwise stages (15x15:
a 7-row halo; 7x7 in the 'gru': 3 rows) and the mask head's 3x3 fetch
their halos; every other conv is 1x1, and the motion hidden state shifts
across interior frames, not rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.depthwise import depthwise_stage
from ..kernels.pointwise import pointwise_stage
from ..runtime.profiling import span
from . import strips
from .gma import Aggregate


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv outside the PCBlocks (a motion encoder's flow input, 4 or
    2 channels) on NHWC x, as a plain product."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class PCBlock4(nn.Module):
    """`PCBlock4_Deep_nopool_res` (NHWC): residual 1.5x FFN -> residual
    depthwise super-kernels (k in k_conv) -> residual pointwise -> output
    FFN, GELU after every residual add."""

    def __init__(self, c_in: int, c_out: int, k_conv: Sequence[int]):
        super().__init__()
        mid = int(1.5 * c_in)
        self.conv_list = nn.ModuleList(
            nn.Conv2d(c_in, c_in, k, padding=k // 2, groups=c_in) for k in k_conv
        )
        self.ffn1 = nn.Sequential(nn.Conv2d(c_in, mid, 1), nn.GELU(), nn.Conv2d(mid, c_in, 1))
        self.pw = nn.Conv2d(c_in, c_in, 1)
        self.ffn2 = nn.Sequential(nn.Conv2d(c_in, mid, 1), nn.GELU(), nn.Conv2d(mid, c_out, 1))

    def depthwise_stages(self, x: torch.Tensor) -> torch.Tensor:
        """x = gelu(x + conv(x)) for each conv_list entry, on NHWC x: one
        K7 stage per k > 1 entry, a k = 1 entry before it folded in as the
        stage's prologue (the kernel on the card in every grad mode; a
        backward runs through its plain twin)."""
        xh = x
        pre = None
        for j, conv in enumerate(self.conv_list):
            k = conv.kernel_size[0]
            if k == 1 and pre is None and j + 1 < len(self.conv_list):
                pre = conv                      # the next entry's prologue
                continue
            rows, pads = strips.depthwise_rows(xh, k)
            xh = depthwise_stage(rows, conv.weight, conv.bias, None if pre is None else pre.weight,
                                 None if pre is None else pre.bias, pads=pads)
            pre = None
        return xh

    def forward(self, x: torch.Tensor, act: bool = False) -> torch.Tensor:
        """NHWC x [..., c_in] -> [..., c_out]; act: GELU on the output too,
        folded into the last launch (the motion encoders' gelu(convc1)).
        Each 1x1 conv is one K8 launch; pad: the output's rows padded for
        the next launch (kernels/pointwise.py)."""
        f1, f2 = self.ffn1, self.ffn2
        x = pointwise_stage(pointwise_stage(x, f1[0].weight, f1[0].bias, act=True, pad=True),
                            f1[2].weight, f1[2].bias, x, act=True)
        x = self.depthwise_stages(x)
        x = pointwise_stage(x, self.pw.weight, self.pw.bias, x, act=True)   # a new tensor: never aliases x
        return pointwise_stage(pointwise_stage(x, f2[0].weight, f2[0].bias, act=True, pad=True),
                               f2[2].weight, f2[2].bias, act=act)


class SKMotionEncoderMOF(nn.Module):
    """`SKMotionEncoder6_Deep_nopool_res`: bidirectional correlation lookup
    + 4-channel flow + the 48-channel motion hidden states of the
    neighbouring interior frames -> 128-channel motion features (NHWC)."""

    def __init__(self, corr_levels: int, corr_radius: int, k_conv: Sequence[int], hidden_ch: int = 48):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2 * 2
        self.hidden_ch = hc = hidden_ch
        self.convc1 = PCBlock4(cor_planes, 256, k_conv)
        self.convc2 = PCBlock4(256, 192, k_conv)
        self.init_hidden_state = nn.Parameter(torch.randn(1, 1, hc, 1, 1))
        self.convf1_ = nn.Conv2d(4, 128, 1)
        self.convf2 = PCBlock4(128, 64, k_conv)
        self.conv = PCBlock4(64 + 192 + hc * 3, 128 - 4 + hc, k_conv)

    def forward(
        self, flow: torch.Tensor, mhs: Optional[torch.Tensor], corr: torch.Tensor, bs: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """flow [B*N, h, w, 4], corr [B*N, h, w, cor_planes], mhs
        [B, N, h, w, 48] or None (the learned init) -> (motion features
        [B*N, h, w, 128], new mhs [B, N, h, w, 48])."""
        bn, h, w, _ = flow.shape
        n = bn // bs
        hc = self.hidden_ch
        if mhs is None:
            mhs = self.init_hidden_state.to(corr.dtype).reshape(1, 1, 1, 1, hc).expand(bs, n, h, w, hc)
        zeros = torch.zeros((bs, 1, h, w, hc), dtype=mhs.dtype, device=mhs.device)
        fwd_mhs = torch.cat([mhs[:, 1:], zeros], dim=1).reshape(bn, h, w, hc)
        bwd_mhs = torch.cat([zeros, mhs[:, :-1]], dim=1).reshape(bn, h, w, hc)
        cur_mhs = mhs.reshape(bn, h, w, hc)

        cor = self.convc2(self.convc1(corr, act=True))
        flow = flow.to(corr.dtype)
        flo = self.convf2(conv1x1(self.convf1_, flow))
        x = torch.cat([cor, flo, fwd_mhs, bwd_mhs, cur_mhs], dim=-1)
        if x.device.type == "cpu":
            # Channel-major, as the former NCHW composition held it: CPU
            # kernels round by layout (GELU's vector tails), and f32 results
            # then stay that code's bit for bit.  The card reads NHWC rows.
            x = nchw_to_nhwc(nhwc_to_nchw(x).contiguous())
        out = self.conv(x)
        motion, new_mhs = torch.split(out, [128 - 4, hc], dim=-1)
        return torch.cat([motion, flow], dim=-1), new_mhs.reshape(bs, n, h, w, hc)


class SKUpdateBlockMOF(nn.Module):
    """`SKUpdateBlock6_Deep_nopoolres_AllDecoder2`: one joint bidirectional
    refinement step.

    net'  = PCBlock([net, inp, motion, gma(motion)])   ("gru")
    delta = PCBlock(net') -> 4 channels                ("flow_head")
    mask  = 0.25 * conv stack(net') -> 2*64*9 channels ("mask")
    """

    def __init__(
        self,
        corr_levels: int = 4,
        corr_radius: int = 4,
        hidden_dim: int = 128,
        k_conv: Sequence[int] = (1, 15),
        pc_updater_conv: Sequence[int] = (1, 7),
        context_dim: int = 128,
    ):
        super().__init__()
        self.encoder = SKMotionEncoderMOF(corr_levels, corr_radius, k_conv)
        self.gru = PCBlock4(128 + hidden_dim + context_dim + 128, hidden_dim, pc_updater_conv)
        self.flow_head = PCBlock4(hidden_dim, 4, k_conv)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9 * 2, 1),
        )
        # GMA's q/k and v have the context's width (Attention in MOFNet).
        self.aggregator = Aggregate(dim=128, dim_head=context_dim)

    @span("tpuflow.sk.update")
    def step(self, net, mhs, inp, corr, flow, q, k, bs: int, attn=None):
        """The refinement step without the mask head (NHWC in and out):
        net, inp [B*N, h, w, 128], corr [B*N, h, w, 2*L*(2r+1)^2], flow
        [B*N, h, w, 4] f32, q/k [B*N, h, w, 128], mhs [B, N, h, w, 48] or
        None, attn [B*N, hw, hw] materialized GMA probabilities or None ->
        (net, mhs, delta_flow)."""
        motion, mhs = self.encoder(flow, mhs, corr, bs)
        motion_global = self.aggregator(q, k, motion, attn)
        net = self.gru(torch.cat([net, inp, motion, motion_global], dim=-1))
        return net, mhs, self.flow_head(net)

    @span("tpuflow.sk.update")
    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        """[B*N, h, w, 128] -> [B*N, h, w, 2*576] convex-upsample weights."""
        x = self.mask[1](strips.conv_same(self.mask[0], nhwc_to_nchw(net)))
        return nchw_to_nhwc(0.25 * self.mask[2](x))

    def forward(self, net, mhs, inp, corr, flow, q, k, bs: int):
        """One full step, as the reference's update block returns it:
        (net, mhs, mask, delta_flow), all NHWC."""
        net, mhs, delta = self.step(net, mhs, inp, corr, flow, q, k, bs)
        return net, mhs, self.upsample_mask(net), delta


class SKMotionEncoderMem(nn.Module):
    """MemFlow's two-frame motion encoder: the correlation lookup, the
    2-channel flow and the memory readout -> 128-channel motion features
    (NHWC)."""

    def __init__(self, corr_levels: int, corr_radius: int, k_conv: Sequence[int], value_dim: int = 128):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = PCBlock4(cor_planes, 256, k_conv)
        self.convc2 = PCBlock4(256, 192, k_conv)
        self.convf1_ = nn.Conv2d(2, 128, 1)
        self.convf2 = PCBlock4(128, 64, k_conv)
        self.conv = PCBlock4(192 + 64 + value_dim, 128 - 2, k_conv)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor, mem_read: torch.Tensor) -> torch.Tensor:
        """flow [B, h, w, 2], corr [B, h, w, cor_planes], mem_read [B, h, w,
        128] -> [B, h, w, 128]."""
        cor = self.convc2(self.convc1(corr, act=True))
        flow = flow.to(corr.dtype)
        flo = self.convf2(conv1x1(self.convf1_, flow))
        out = self.conv(torch.cat([cor, flo, mem_read], dim=-1))
        return torch.cat([out, flow], dim=-1)


class SKUpdateBlockMem(nn.Module):
    """MemFlow's update block: the motion encoder with the once-per-frame
    memory readout, GMA aggregation, PCBlock 'gru', 2-channel flow head and
    a 64*9-channel upsample mask."""

    def __init__(
        self,
        corr_levels: int = 4,
        corr_radius: int = 4,
        hidden_dim: int = 128,
        k_conv: Sequence[int] = (1, 15),
        pc_updater_conv: Sequence[int] = (1, 7),
        value_dim: int = 128,
    ):
        super().__init__()
        self.encoder = SKMotionEncoderMem(corr_levels, corr_radius, k_conv, value_dim)
        self.gru = PCBlock4(128 + hidden_dim + hidden_dim + 128, hidden_dim, pc_updater_conv)
        self.flow_head = PCBlock4(hidden_dim, 2, k_conv)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1),
        )
        self.aggregator = Aggregate(dim=128)

    @span("tpuflow.sk.update")
    def step(self, net, inp, corr, flow, q, k, mem_read, attn=None):
        """The refinement step without the mask head (NHWC in and out): net,
        inp [B, h, w, 128], corr [B, h, w, L*(2r+1)^2], flow [B, h, w, 2]
        f32, q/k [B, h, w, 128], mem_read [B, h, w, 128], attn [B, hw, hw]
        or None (kernel K2) -> (net, motion, delta_flow)."""
        motion = self.encoder(flow, corr, mem_read)
        motion_global = self.aggregator(q, k, motion, attn)
        net = self.gru(torch.cat([net, inp, motion, motion_global], dim=-1))
        return net, motion, self.flow_head(net)

    @span("tpuflow.sk.update")
    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        """[B, h, w, 128] -> [B, h, w, 576] convex-upsample weights."""
        return nchw_to_nhwc(0.25 * self.mask(nhwc_to_nchw(net)))

    def forward(self, net, inp, corr, flow, q, k, mem_read, attn=None):
        """One full step, as the reference's update block returns it: (net,
        motion, mask, delta_flow), all NHWC."""
        net, motion, delta = self.step(net, inp, corr, flow, q, k, mem_read, attn)
        return net, motion, self.upsample_mask(net), delta
