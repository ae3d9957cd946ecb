"""Twins-SVT feature/context encoder (port of tpuflow/core/encoders.py's
TwinsSVT): timm twins_svt_large truncated to its first two stages,
[B, H, W, 3] -> [B, H/8, W/8, 256].

Stage hyper-parameters (timm): dims (128, 256), depths (2, 2), heads (4, 8),
sub-sampling ratios (8, 4), window 7, MLP ratio 4.  Blocks alternate
locally-grouped attention (even j, ws=7) and global sub-sampled attention
(odd j); the positional conv follows block 0 of each stage.  Tokens are
[B, h*w, C] (NHWC order); convs run on NCHW views of them.

Strided convs pad as flax's default 'SAME' does, which is what the JAX
reference runs: at a 270x240 stage-1 grid with sr=8 that gives 34x30 keys,
where upstream timm (padding 0) gives 33x30.

State-dict names: fnet.svt.patch_embeds.{i}.proj|norm, fnet.svt.pos_block.
{i}.proj.0, fnet.svt.blocks.{i}.{j}.{norm1,attn.*,norm2,mlp.fc1,mlp.fc2}.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in f32; tanh approximation in bf16, as the reference
    (encoders.py:29-33, sk.py:35-40)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) with the scores and the softmax in f32, as the
    reference's f32-accumulated einsum, returned in q's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    return torch.softmax(scores, dim=-1).to(q.dtype)


def same_pad_strided(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero-pad NCHW x for a k x k stride-s conv the way flax 'SAME' does:
    total max((ceil(n/s)-1)*s + k - n, 0) per axis, low side total//2."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def tokens_to_nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


def nchw_to_tokens(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).flatten(1, 2)


class TwinsMlp(nn.Module):
    def __init__(self, dim: int, ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class LocallyGroupedAttn(nn.Module):
    """Windowed multi-head attention with a fused qkv projection; the grid
    is zero-padded at the bottom/right to a multiple of ws."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, size):
        b, n, c = x.shape
        h, w = size
        ws, nh = self.ws, self.num_heads
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        gh, gw = hp // ws, wp // ws
        x = x.reshape(b, gh, ws, gw, ws, c).transpose(2, 3)
        qkv = self.qkv(x).reshape(b, gh * gw, ws * ws, 3, nh, c // nh).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = attention_probs(q, k, self.scale)
        out = (attn @ v).transpose(2, 3).reshape(b, gh, gw, ws, ws, c)
        out = out.transpose(2, 3).reshape(b, hp, wp, c)[:, :h, :w]
        return self.proj(out.reshape(b, n, c))


class GlobalSubSampleAttn(nn.Module):
    """Full-resolution queries against keys/values from an sr-strided conv
    sub-sample (SAME padding, see module docstring)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x, size):
        b, n, c = x.shape
        nh = self.num_heads
        q = self.q(x).reshape(b, n, nh, c // nh).permute(0, 2, 1, 3)
        kv_in = x
        if self.sr_ratio > 1:
            xs = same_pad_strided(tokens_to_nchw(x, *size), self.sr_ratio, self.sr_ratio)
            kv_in = self.norm(nchw_to_tokens(self.sr(xs)))
        kv = self.kv(kv_in).reshape(b, -1, 2, nh, c // nh).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        attn = attention_probs(q, k, self.scale)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class TwinsBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, ws: int):
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
        return x + self.mlp(self.norm2(x))


class TwinsPatchEmbed(nn.Module):
    """Strided-conv patch embedding + LayerNorm (timm PatchEmbed)."""

    def __init__(self, in_ch: int, dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_ch, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = self.proj(same_pad_strided(x, self.patch, self.patch))
        size = (x.shape[2], x.shape[3])
        return self.norm(nchw_to_tokens(x)), size


class PosConv(nn.Module):
    """Conditional positional encoding: residual depthwise 3x3."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x, size):
        feat = tokens_to_nchw(x, *size)
        return nchw_to_tokens(self.proj(feat) + feat)


class TwinsSVT(nn.Module):
    """twins_svt_large, first two stages: [B, H, W, 3] -> [B, H/8, W/8, 256]."""

    def __init__(
        self,
        dims: Sequence[int] = (128, 256),
        depths: Sequence[int] = (2, 2),
        heads: Sequence[int] = (4, 8),
        sr_ratios: Sequence[int] = (8, 4),
        ws: int = 7,
    ):
        super().__init__()
        self.patch_embeds = nn.ModuleList()
        self.pos_block = nn.ModuleList()
        self.blocks = nn.ModuleList()
        in_ch = 3
        for i, dim in enumerate(dims):
            self.patch_embeds.append(TwinsPatchEmbed(in_ch, dim, 4 if i == 0 else 2))
            self.pos_block.append(PosConv(dim))
            self.blocks.append(
                nn.ModuleList(
                    TwinsBlock(dim, heads[i], sr_ratios[i], ws if j % 2 == 0 else 1)
                    for j in range(depths[i])
                )
            )
            in_ch = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for embed, blocks, pos in zip(self.patch_embeds, self.blocks, self.pos_block):
            x, size = embed(x)
            for j, blk in enumerate(blocks):
                x = blk(x, size)
                if j == 0:
                    x = pos(x, size)
            x = tokens_to_nchw(x, *size)
        return x.permute(0, 2, 3, 1)


class TwinsEncoder(nn.Module):
    """VideoFlow's encoder wrapper (`self.svt = timm.create_model(...)`),
    kept for the upstream state-dict prefix `fnet.svt.` / `cnet.svt.`."""

    def __init__(self):
        super().__init__()
        self.svt = TwinsSVT()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.svt(x)


def make_encoder(kind: str, output_dim: int = 256) -> nn.Module:
    if kind == "twins":
        if output_dim != 256:
            raise ValueError("twins_svt_large's 2-stage output is 256-dim")
        return TwinsEncoder()
    raise NotImplementedError(
        f"encoder {kind!r}: only 'twins' is ported; the cnn BasicEncoder is a "
        "later slice of the port (see ROADMAP.md)."
    )
