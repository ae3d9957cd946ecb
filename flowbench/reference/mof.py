"""Plain reference of VideoFlow's MOFNet (Shi et al., ICCV 2023), in float32
PyTorch: the benchmark's frozen copy of the repository's independent test
mirror (upstream names and layouts: MOFNet + SKFlow update + GMA + timm
twins_svt_large, first two stages).  It imports nothing of the program.

Edits against the mirror, none of which changes the mathematics:
- every tensor it creates is made on its inputs' device;
- the encoders run one frame at a time, and the softmax of every global
  attention (Twins' sub-sampled attention, GMA) runs over blocks of
  ROW_BLOCK query rows, so that a 1080p window fits one card.

Known divergences from upstream, as in the mirror: `init_hidden_state` is
stored as (1, 1, 48, 1, 1); Twins stages 3-4 and the classifier head are
left out (the forward never reaches them); GMA's RelPosEmb is left out
(the upstream config runs content-only attention).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# Query rows per block of a global attention's softmax.
ROW_BLOCK = 8192


def blocked_softmax_matmul(q, k, v=None, scale=1.0):
    """softmax(scale * q @ k^T) (@ v when v is given) over blocks of
    ROW_BLOCK query rows; q [..., N, D], k [..., M, D], v [..., M, E]."""
    outs = []
    for q_blk in q.split(ROW_BLOCK, dim=-2):
        attn = ((q_blk @ k.transpose(-2, -1)) * scale).softmax(dim=-1)
        outs.append(attn if v is None else attn @ v)
    return torch.cat(outs, dim=-2)


# ---------------------------------------------------------------------------
# SKFlow blocks
# ---------------------------------------------------------------------------
class PCBlock4_Deep_nopool_res(nn.Module):
    def __init__(self, c_in, c_out, k_conv):
        super().__init__()
        self.conv_list = nn.ModuleList(
            [nn.Conv2d(c_in, c_in, k, padding=k // 2, groups=c_in) for k in k_conv]
        )
        self.ffn1 = nn.Sequential(
            nn.Conv2d(c_in, int(1.5 * c_in), 1),
            nn.GELU(),
            nn.Conv2d(int(1.5 * c_in), c_in, 1),
        )
        self.pw = nn.Conv2d(c_in, c_in, 1)
        self.ffn2 = nn.Sequential(
            nn.Conv2d(c_in, int(1.5 * c_in), 1),
            nn.GELU(),
            nn.Conv2d(int(1.5 * c_in), c_out, 1),
        )

    def forward(self, x):
        x = F.gelu(x + self.ffn1(x))
        for conv in self.conv_list:
            x = F.gelu(x + conv(x))
        x = F.gelu(x + self.pw(x))
        return self.ffn2(x)


class SKMotionEncoder6_Deep_nopool_res(nn.Module):
    def __init__(self, corr_levels, corr_radius, k_conv, hidden_ch=48):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2 * 2
        self.hidden_ch = hc = hidden_ch
        self.convc1 = PCBlock4_Deep_nopool_res(cor_planes, 256, k_conv)
        self.convc2 = PCBlock4_Deep_nopool_res(256, 192, k_conv)
        self.init_hidden_state = nn.Parameter(torch.randn(1, 1, hc, 1, 1))
        self.convf1_ = nn.Conv2d(4, 128, 1, 1, 0)
        self.convf2 = PCBlock4_Deep_nopool_res(128, 64, k_conv)
        self.conv = PCBlock4_Deep_nopool_res(64 + 192 + hc * 3, 128 - 4 + hc, k_conv)

    def forward(self, flow, motion_hidden_state, corr, bs):
        bn, _, h, w = flow.shape
        n = bn // bs
        hc = self.hidden_ch
        if motion_hidden_state is None:
            motion_hidden_state = self.init_hidden_state.expand(bs, n, hc, h, w)
        else:
            motion_hidden_state = motion_hidden_state.reshape(bs, n, hc, h, w)

        zeros = torch.zeros((bs, 1, hc, h, w), dtype=flow.dtype, device=flow.device)
        fwd_mhs = torch.cat([motion_hidden_state[:, 1:], zeros], dim=1).reshape(bn, hc, h, w)
        bwd_mhs = torch.cat([zeros, motion_hidden_state[:, :-1]], dim=1).reshape(bn, hc, h, w)
        cur_mhs = motion_hidden_state.reshape(bn, hc, h, w)

        cor = F.gelu(self.convc1(corr))
        cor = self.convc2(cor)
        flo = self.convf1_(flow)
        flo = self.convf2(flo)
        cat = torch.cat([cor, flo, fwd_mhs, bwd_mhs, cur_mhs], dim=1)
        out = self.conv(cat)
        motion_feat, new_mhs = torch.split(out, [128 - 4, hc], dim=1)
        return torch.cat([motion_feat, flow], dim=1), new_mhs


# ---------------------------------------------------------------------------
# GMA
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Content-only GMA attention, heads=1 (upstream VideoFlow config)."""

    def __init__(self, dim, dim_head):
        super().__init__()
        self.scale = dim_head ** -0.5
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, fmap):
        b, _, h, w = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        q = (q * self.scale).flatten(2).transpose(1, 2)  # [B, HW, D]
        k = k.flatten(2).transpose(1, 2)
        return blocked_softmax_matmul(q, k)  # [B, HW, HW]


class Aggregate(nn.Module):
    def __init__(self, dim, dim_head):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = (
            nn.Conv2d(dim_head, dim, 1, bias=False) if dim != dim_head else None
        )

    def forward(self, attn, fmap):
        b, c, h, w = fmap.shape
        v = self.to_v(fmap).flatten(2).transpose(1, 2)  # [B, HW, D]
        out = (attn @ v).transpose(1, 2).reshape(b, -1, h, w)
        if self.project is not None:
            out = self.project(out)
        return fmap + self.gamma * out


class SKUpdateBlock6_Deep_nopoolres_AllDecoder2(nn.Module):
    def __init__(self, corr_levels, corr_radius, hidden_dim=128,
                 k_conv=(1, 15), pc_updater_conv=(1, 7)):
        super().__init__()
        self.encoder = SKMotionEncoder6_Deep_nopool_res(corr_levels, corr_radius, k_conv)
        self.gru = PCBlock4_Deep_nopool_res(
            128 + hidden_dim + hidden_dim + 128, hidden_dim, pc_updater_conv
        )
        self.flow_head = PCBlock4_Deep_nopool_res(hidden_dim, 4, k_conv)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9 * 2, 1, padding=0),
        )
        self.aggregator = Aggregate(dim=128, dim_head=128)

    def forward(self, net, motion_hidden_state, inp, corr, flow, attention, bs):
        motion_features, motion_hidden_state = self.encoder(
            flow, motion_hidden_state, corr, bs
        )
        motion_global = self.aggregator(attention, motion_features)
        x = torch.cat([net, inp, motion_features, motion_global], dim=1)
        net = self.gru(x)
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, motion_hidden_state, mask, delta_flow


# ---------------------------------------------------------------------------
# Twins-SVT (timm twins_svt_large, first two stages)
# ---------------------------------------------------------------------------
class TwinsMlp(nn.Module):
    def __init__(self, dim, ratio=4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LocallyGroupedAttn(nn.Module):
    def __init__(self, dim, num_heads, ws=7):
        super().__init__()
        self.dim, self.num_heads, self.ws = dim, num_heads, ws
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, size):
        b, n, c = x.shape
        h, w = size
        ws, nh = self.ws, self.num_heads
        x = x.view(b, h, w, c)
        pad_r = (ws - w % ws) % ws
        pad_b = (ws - h % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        gh, gw = hp // ws, wp // ws
        x = x.reshape(b, gh, ws, gw, ws, c).transpose(2, 3)
        qkv = (
            self.qkv(x)
            .reshape(b, gh * gw, ws * ws, 3, nh, c // nh)
            .permute(3, 0, 1, 4, 2, 5)
        )
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * self.scale
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(2, 3).reshape(b, gh, gw, ws, ws, c)
        out = out.transpose(2, 3).reshape(b, hp, wp, c)
        out = out[:, :h, :w].reshape(b, n, c)
        return self.proj(out)


class GlobalSubSampleAttn(nn.Module):
    def __init__(self, dim, num_heads, sr_ratio):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim, bias=True)
        self.kv = nn.Linear(dim, 2 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x, size):
        b, n, c = x.shape
        h, w = size
        nh = self.num_heads
        q = self.q(x).reshape(b, n, nh, c // nh).permute(0, 2, 1, 3)
        kv_in = x
        if self.sr_ratio > 1:
            xs = x.transpose(1, 2).reshape(b, c, h, w)
            xs = self.sr(xs).reshape(b, c, -1).transpose(1, 2)
            kv_in = self.norm(xs)
        kv = (
            self.kv(kv_in)
            .reshape(b, -1, 2, nh, c // nh)
            .permute(2, 0, 3, 1, 4)
        )
        k, v = kv[0], kv[1]
        out = blocked_softmax_matmul(q, k, v, self.scale).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class TwinsBlock(nn.Module):
    def __init__(self, dim, num_heads, sr_ratio, ws):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        if ws == 1:
            self.attn = GlobalSubSampleAttn(dim, num_heads, sr_ratio)
        else:
            self.attn = LocallyGroupedAttn(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = TwinsMlp(dim)

    def forward(self, x, size):
        x = x + self.attn(self.norm1(x), size)
        x = x + self.mlp(self.norm2(x))
        return x


class PatchEmbed(nn.Module):
    def __init__(self, in_ch, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = self.proj(x)
        size = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x), size


class PosConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, bias=True, groups=dim))

    def forward(self, x, size):
        b, n, c = x.shape
        feat = x.transpose(1, 2).reshape(b, c, *size)
        x = self.proj(feat) + feat
        return x.flatten(2).transpose(1, 2)


class _TwinsSVT2Stage(nn.Module):
    """timm twins_svt_large truncated to the stages VideoFlow runs."""

    def __init__(self, dims=(128, 256), depths=(2, 2), heads=(4, 8), sr=(8, 4), ws=7):
        super().__init__()
        self.depths = depths
        self.patch_embeds = nn.ModuleList()
        self.pos_block = nn.ModuleList()
        self.blocks = nn.ModuleList()
        in_ch = 3
        for i, dim in enumerate(dims):
            self.patch_embeds.append(PatchEmbed(in_ch, dim, 4 if i == 0 else 2))
            self.pos_block.append(PosConv(dim))
            self.blocks.append(
                nn.ModuleList(
                    [
                        TwinsBlock(dim, heads[i], sr[i], ws if j % 2 == 0 else 1)
                        for j in range(depths[i])
                    ]
                )
            )
            in_ch = dim

    def forward(self, x, layer=2):
        b = x.shape[0]
        for i, (embed, blocks, pos_blk) in enumerate(
            zip(self.patch_embeds, self.blocks, self.pos_block)
        ):
            x, size = embed(x)
            for j, blk in enumerate(blocks):
                x = blk(x, size)
                if j == 0:
                    x = pos_blk(x, size)
            x = x.reshape(b, *size, -1).permute(0, 3, 1, 2).contiguous()
            if i == layer - 1:
                break
        return x


class twins_svt_large(nn.Module):
    """VideoFlow's encoder wrapper: `self.svt = timm.create_model(...)`."""

    def __init__(self):
        super().__init__()
        self.svt = _TwinsSVT2Stage()

    def forward(self, x):
        return torch.cat([self.svt(f, layer=2) for f in x.split(1)])


# ---------------------------------------------------------------------------
# RAFT-style correlation block (zero-pad grid_sample, x-major window)
# ---------------------------------------------------------------------------
def bilinear_sampler(img, coords):
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


class CorrBlock:
    def __init__(self, fmap1, fmap2, num_levels=4, radius=4):
        self.num_levels = num_levels
        self.radius = radius
        b, c, h, w = fmap1.shape
        corr = torch.einsum(
            "bci,bcj->bij", fmap1.flatten(2), fmap2.flatten(2)
        ) / math.sqrt(c)
        corr = corr.reshape(b * h * w, 1, h, w)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)
        self.shape = (b, h, w)

    def __call__(self, coords):
        # coords: [B, 2, H, W] absolute (x, y)
        r = self.radius
        b, h, w = self.shape
        coords = coords.permute(0, 2, 3, 1)
        out = []
        for i, corr in enumerate(self.pyramid):
            d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            # Upstream quirk (RAFT corr.py): delta = meshgrid(dy, dx)
            # stacked last, added to (x, y) coords -> the FIRST window
            # axis offsets x, the second offsets y.
            delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
            centroid = coords.reshape(b * h * w, 1, 1, 2) / 2 ** i
            coords_lvl = centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2)
            sampled = bilinear_sampler(corr, coords_lvl)
            out.append(sampled.view(b, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def coords_grid(b, h, w, device=None):
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=0).float()[None].repeat(b, 1, 1, 1)


# ---------------------------------------------------------------------------
# MOFNet mirror
# ---------------------------------------------------------------------------
class MOFNetMirror(nn.Module):
    def __init__(self, corr_levels=4, corr_radius=4, decoder_depth=12,
                 hidden_dim=128, context_dim=128):
        super().__init__()
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.decoder_depth = decoder_depth
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.fnet = twins_svt_large()
        self.cnet = twins_svt_large()
        self.att = Attention(dim=context_dim, dim_head=context_dim)
        self.update_block = SKUpdateBlock6_Deep_nopoolres_AllDecoder2(
            corr_levels, corr_radius, hidden_dim
        )

    def forward(self, frames):
        # frames: [B, T, 3, H, W] in [0, 1]
        b, t, _, H, W = frames.shape
        n = t - 2
        x = 2.0 * frames - 1.0
        feats = self.fnet(x.reshape(b * t, 3, H, W))
        _, c8, h8, w8 = feats.shape
        feats = feats.reshape(b, t, c8, h8, w8)

        ctx = self.cnet(x[:, 1 : t - 1].reshape(b * n, 3, H, W))
        net = torch.tanh(ctx[:, : self.hidden_dim])
        inp = torch.relu(ctx[:, self.hidden_dim :])
        attention = self.att(inp)

        center = feats[:, 1 : t - 1].reshape(b * n, c8, h8, w8)
        fwd_tgt = feats[:, 2:t].reshape(b * n, c8, h8, w8)
        bwd_tgt = feats[:, 0 : t - 2].reshape(b * n, c8, h8, w8)
        corr_fwd = CorrBlock(center, fwd_tgt, self.corr_levels, self.corr_radius)
        corr_bwd = CorrBlock(center, bwd_tgt, self.corr_levels, self.corr_radius)

        grid = coords_grid(b * n, h8, w8, frames.device)
        flow = torch.zeros((b * n, 4, h8, w8), device=frames.device)
        mhs = None
        for _ in range(self.decoder_depth):
            cf = corr_fwd(grid + flow[:, 0:2])
            cb = corr_bwd(grid + flow[:, 2:4])
            corr = torch.cat([cf, cb], dim=1)
            net, mhs, mask, delta = self.update_block(
                net, mhs, inp, corr, flow, attention, b
            )
            flow = flow + delta

        up_fwd = upsample_flow(flow[:, 0:2], mask[:, : 64 * 9])
        up_bwd = upsample_flow(flow[:, 2:4], mask[:, 64 * 9 :])
        return (
            up_fwd.reshape(b, n, 2, H, W),
            up_bwd.reshape(b, n, 2, H, W),
        )


def upsample_flow(flow, mask):
    n, _, h, w = flow.shape
    mask = mask.view(n, 1, 9, 8, 8, h, w)
    mask = torch.softmax(mask, dim=2)
    up = F.unfold(8 * flow, (3, 3), padding=1)
    up = up.view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)
    up = up.permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)
