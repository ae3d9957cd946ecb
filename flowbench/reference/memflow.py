"""Plain reference of MemFlowNet (Dong & Fu, CVPR 2024, arXiv:2404.04808), in
float32 PyTorch: the benchmark's frozen copy of the repository's
independent test mirror.  It shares the VideoFlow stack of `mof.py`
(twins_svt_large fnet/cnet, GMA, SKFlow blocks, the RAFT correlation block,
convex upsampling) and adds a ring memory of (context key, motion value)
token maps, one cross-attention readout per frame over every memory token
(2D RoPE when `use_rope`), joined to the motion encoder's input of every
iteration, and single-direction flow.  It imports nothing of the program.

Edits against the mirror, none of which changes the mathematics: every
tensor it creates is made on its inputs' device, and the readout's softmax
runs over blocks of query rows (mof.ROW_BLOCK).

The memory modules are role-named (qk_proj, v_proj, memory_reader.out_proj)
as in the mirror; upstream's attribute names and these widths could not be
confirmed from the snapshot the repository was built from.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mof import (
    ROW_BLOCK,
    Aggregate,
    Attention,
    CorrBlock,
    PCBlock4_Deep_nopool_res,
    coords_grid,
    twins_svt_large,
    upsample_flow,
)


# ---------------------------------------------------------------------------
# Memory (keys/values ring buffer + RoPE readout)
# ---------------------------------------------------------------------------
def init_memory(batch, capacity, hw, key_dim, value_dim, device=None):
    return {
        "keys": torch.zeros(batch, capacity, hw, key_dim, device=device),
        "values": torch.zeros(batch, capacity, hw, value_dim, device=device),
        "valid": torch.zeros(batch, capacity, device=device),
        "ptr": torch.zeros(batch, dtype=torch.long, device=device),
    }


def memory_write(mem, key, value):
    """Ring-buffer write at ptr (per batch element) — mirrors
    core/memflownet.memory_write."""
    cap = mem["valid"].shape[1]
    slot = mem["ptr"] % cap
    onehot = F.one_hot(slot, cap).to(mem["keys"].dtype)  # [B, cap]
    oh = onehot[..., None, None]
    return {
        "keys": mem["keys"] * (1 - oh) + oh * key[:, None],
        "values": mem["values"] * (1 - oh) + oh * value[:, None],
        "valid": torch.maximum(mem["valid"], onehot),
        "ptr": mem["ptr"] + 1,
    }


def rope_2d(t, h, w):
    """2D rotary embedding over a [..., h*w, d] token axis — mirrors
    core/memflownet.rope_2d (first d/2 channels rotate with x, second
    with y; standard RoPE pairs within each half)."""
    d = t.shape[-1]
    dh = d // 2
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=t.device),
        torch.arange(w, dtype=torch.float32, device=t.device),
        indexing="ij",
    )
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)

    def rot(x, pos):
        half = dh // 2
        freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos[:, None] * freqs[None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    return torch.cat([rot(t[..., :dh], xs), rot(t[..., dh:], ys)], dim=-1)


class MemoryReader(nn.Module):
    """Cross-attention readout over all (time x space) memory tokens,
    zeros when the memory is empty (frame 0)."""

    def __init__(self, key_dim=64, value_dim=128, use_rope=False):
        super().__init__()
        self.use_rope = use_rope
        self.out_proj = nn.Conv2d(value_dim, 128, 1)

    def forward(self, query, mem):
        # query: [B, dk, h, w] (NCHW)
        b, dk, h, w = query.shape
        hw = h * w
        cap = mem["valid"].shape[1]
        dv = mem["values"].shape[-1]
        scale = dk ** -0.5

        q = query.flatten(2).transpose(1, 2) * scale  # [B, hw, dk]
        k = mem["keys"]                               # [B, cap, hw, dk]
        if self.use_rope:
            q = rope_2d(q, h, w)
            k = rope_2d(k, h, w)
        k = k.reshape(b, cap * hw, dk)
        v = mem["values"].reshape(b, cap * hw, dv)

        tok_valid = mem["valid"].repeat_interleave(hw, dim=1)  # [B, cap*hw]
        reads = []
        for q_blk in q.split(ROW_BLOCK, dim=1):
            sim = q_blk @ k.transpose(1, 2)                    # [B, rows, cap*hw]
            sim = sim.masked_fill(tok_valid[:, None, :] <= 0, -1e9)
            reads.append(sim.softmax(dim=-1) @ v)
        read = torch.cat(reads, dim=1)                         # [B, hw, dv]
        any_valid = (mem["valid"].sum(dim=1) > 0).float()[:, None, None]
        read = read * any_valid
        read = read.transpose(1, 2).reshape(b, dv, h, w)
        return self.out_proj(read)


# ---------------------------------------------------------------------------
# SK update block (single-direction, memory readout joins the encoder)
# ---------------------------------------------------------------------------
class SKMotionEncoderMem(nn.Module):
    def __init__(self, corr_levels, corr_radius, k_conv, value_dim=128):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = PCBlock4_Deep_nopool_res(cor_planes, 256, k_conv)
        self.convc2 = PCBlock4_Deep_nopool_res(256, 192, k_conv)
        self.convf1_ = nn.Conv2d(2, 128, 1, 1, 0)
        self.convf2 = PCBlock4_Deep_nopool_res(128, 64, k_conv)
        self.conv = PCBlock4_Deep_nopool_res(192 + 64 + value_dim, 128 - 2, k_conv)

    def forward(self, flow, corr, mem_read):
        cor = F.gelu(self.convc1(corr))
        cor = self.convc2(cor)
        flo = self.convf1_(flow)
        flo = self.convf2(flo)
        out = self.conv(torch.cat([cor, flo, mem_read], dim=1))
        return torch.cat([out, flow], dim=1)


class SKUpdateBlockMem(nn.Module):
    def __init__(self, corr_levels, corr_radius, hidden_dim=128,
                 k_conv=(1, 15), pc_updater_conv=(1, 7), value_dim=128):
        super().__init__()
        self.encoder = SKMotionEncoderMem(corr_levels, corr_radius, k_conv, value_dim)
        self.gru = PCBlock4_Deep_nopool_res(
            128 + hidden_dim + hidden_dim + 128, hidden_dim, pc_updater_conv
        )
        self.flow_head = PCBlock4_Deep_nopool_res(hidden_dim, 2, k_conv)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1, padding=0),
        )
        self.aggregator = Aggregate(dim=128, dim_head=128)

    def forward(self, net, inp, corr, flow, attention, mem_read):
        motion = self.encoder(flow, corr, mem_read)
        motion_global = self.aggregator(attention, motion)
        x = torch.cat([net, inp, motion, motion_global], dim=1)
        net = self.gru(x)
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, motion, mask, delta_flow


# ---------------------------------------------------------------------------
# MemFlowNet mirror
# ---------------------------------------------------------------------------
class MemFlowNetMirror(nn.Module):
    def __init__(self, corr_levels=4, corr_radius=4, decoder_depth=12,
                 hidden_dim=128, context_dim=128, key_dim=64, value_dim=128,
                 memory_capacity=8, use_rope=False):
        super().__init__()
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.decoder_depth = decoder_depth
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.key_dim, self.value_dim = key_dim, value_dim
        self.memory_capacity = memory_capacity
        self.fnet = twins_svt_large()
        self.cnet = twins_svt_large()
        self.att = Attention(dim=context_dim, dim_head=context_dim)
        self.update_block = SKUpdateBlockMem(
            corr_levels, corr_radius, hidden_dim, value_dim=value_dim
        )
        self.qk_proj = nn.Conv2d(context_dim, key_dim, 1)
        self.v_proj = nn.Conv2d(128, value_dim, 1)
        self.memory_reader = MemoryReader(key_dim, value_dim, use_rope)

    def empty_memory(self, batch, h, w, device=None):
        return init_memory(
            batch, self.memory_capacity, (h // 8) * (w // 8),
            self.key_dim, self.value_dim, device,
        )

    def forward(self, frame_pair, memory, flow_init=None):
        # frame_pair: [B, 2, 3, H, W] in [0, 1]; returns
        # (flow_up [B, 2, H, W], new_memory, flow_low [B, 2, H/8, W/8]).
        b, _, _, H, W = frame_pair.shape
        x = 2.0 * frame_pair - 1.0
        feats = self.fnet(x.reshape(b * 2, 3, H, W))
        _, c8, h8, w8 = feats.shape
        feats = feats.reshape(b, 2, c8, h8, w8)

        ctx = self.cnet(x[:, 0])
        net = torch.tanh(ctx[:, : self.hidden_dim])
        inp = torch.relu(ctx[:, self.hidden_dim :])
        attention = self.att(inp)

        corr = CorrBlock(feats[:, 0], feats[:, 1], self.corr_levels, self.corr_radius)

        qk = self.qk_proj(inp)                    # [B, dk, h8, w8]
        mem_read = self.memory_reader(qk, memory)

        grid = coords_grid(b, h8, w8, frame_pair.device)
        flow = (
            torch.zeros((b, 2, h8, w8), device=frame_pair.device) if flow_init is None else flow_init
        )
        for _ in range(self.decoder_depth):
            cf = corr(grid + flow)
            net, motion, mask, delta = self.update_block(
                net, inp, cf, flow, attention, mem_read
            )
            flow = flow + delta

        value = self.v_proj(motion)
        new_memory = memory_write(
            memory,
            qk.flatten(2).transpose(1, 2),     # [B, hw, dk]
            value.flatten(2).transpose(1, 2),  # [B, hw, dv]
        )
        return upsample_flow(flow, mask), new_memory, flow
