"""Feature/context encoders (port of tpuflow/core/encoders.py), NHWC in and
out, [B, H, W, 3] -> [B, H/8, W/8, C]:

- `TwinsEncoder` ('twins', the upstream checkpoints' backbone): timm
  twins_svt_large truncated to its first two stages, C = 256.
- `BasicEncoder` ('cnn'): the RAFT-style residual CNN of the JAX package,
  conv 7x7/2, three pairs of `ResidualBlock`s (64, 96/2, 128/2) and a 1x1 to
  C.  Its norms are flax GroupNorms (epsilon 1e-6, statistics in f32):
  'instance' one group per channel, 'group' 8 groups, 'batch' one group (the
  JAX package's frozen-BN stand-in), 'none'.  As in the JAX package, the
  stem's norm exists only for 'instance'.

Twins:

Stage hyper-parameters (timm): dims (128, 256), depths (2, 2), heads (4, 8),
sub-sampling ratios (8, 4), window 7, MLP ratio 4.  Blocks alternate
locally-grouped attention (even j, ws=7) and global sub-sampled attention
(odd j); the positional conv follows block 0 of each stage.  Tokens are
[B, h*w, C] (NHWC order); convs run on NCHW views of them.

Strided convs pad as flax's default 'SAME' does, which is what the JAX
reference runs: at a 270x240 stage-1 grid with sr=8 that gives 34x30 keys,
where upstream timm (padding 0) gives 33x30.

State-dict names: fnet.svt.patch_embeds.{i}.proj|norm, fnet.svt.pos_block.
{i}.proj.0, fnet.svt.blocks.{i}.{j}.{norm1,attn.*,norm2,mlp.fc1,mlp.fc2};
for the cnn encoder fnet.conv1, fnet.norm1, fnet.layer{i}.{j}.{conv1,norm1,
conv2,norm2,downsample,norm3}, fnet.conv2 (the JAX package's flax names
with `layer{i}_{j}` written `layer{i}.{j}`).  The cnn encoder has no
upstream checkpoint.
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


# ---- the cnn encoder ------------------------------------------------------


class SameConv2d(nn.Conv2d):
    """A k x k stride-s conv (k odd) padded as flax's default 'SAME' pads:
    k // 2 on each side at stride 1, same_pad_strided above it."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride, padding=k // 2 if stride == 1 else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride[0] > 1:
            x = same_pad_strided(x, self.kernel_size[0], self.stride[0])
        return super().forward(x)


class GroupNorm(nn.GroupNorm):
    """flax GroupNorm on NCHW: epsilon 1e-6, statistics, normalisation and
    the affine in f32 whatever the input's dtype, the result cast back.
    The statistics are one reduction over each group's channels and pixels
    in whatever memory layout the convolution left (channels-last here):
    F.group_norm's per-row moments kernel took 87 % of the cnn encoders'
    device time on that layout (an H100, 1080p tiles)."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(num_groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xf = x.float().reshape(n, self.num_groups, c // self.num_groups, h, w)
        var, mean = torch.var_mean(xf, dim=(2, 3, 4), keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(n, c, h, w)
        return (y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]).to(x.dtype)


NORMS = ("instance", "group", "batch", "none")


def make_norm(norm: str, channels: int) -> nn.Module:
    if norm == "instance":
        return GroupNorm(channels, channels)
    if norm == "group":
        return GroupNorm(8, channels)
    if norm == "batch":
        return GroupNorm(1, channels)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"norm {norm!r}: expected one of {NORMS}")


class ResidualBlock(nn.Module):
    """relu(x' + norm2(conv2(relu(norm1(conv1(x)))))), where x' is x, or its
    1x1 strided projection `downsample` + `norm3` when the stride or the width
    changes.  NCHW."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, norm: str = "instance"):
        super().__init__()
        self.conv1 = SameConv2d(in_planes, planes, 3, stride)
        self.norm1 = make_norm(norm, planes)
        self.conv2 = SameConv2d(planes, planes, 3)
        self.norm2 = make_norm(norm, planes)
        if stride != 1 or in_planes != planes:
            self.downsample = SameConv2d(in_planes, planes, 1, stride)
            self.norm3 = make_norm(norm, planes)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT-style residual encoder, [B, H, W, 3] -> [B, H/8, W/8, output_dim]."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = SameConv2d(3, 64, 7, 2)
        # As the JAX package: the stem is normalised for 'instance' only.
        self.norm1 = make_norm(norm, 64) if norm == "instance" else nn.Identity()
        widths = ((64, 64, 1), (64, 96, 2), (96, 128, 2))
        self.layer1, self.layer2, self.layer3 = (
            nn.ModuleList([ResidualBlock(cin, cout, s, norm), ResidualBlock(cout, cout, 1, norm)])
            for cin, cout, s in widths
        )
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x.permute(0, 3, 1, 2))))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x)
        return self.conv2(x).permute(0, 2, 3, 1)


def make_encoder(kind: str, output_dim: int = 256, norm: str = "instance") -> nn.Module:
    """'twins' (output_dim 256; `norm` unused, as in the JAX package) or
    'cnn' (BasicEncoder with `norm`)."""
    if kind == "twins":
        if output_dim != 256:
            raise ValueError("twins_svt_large's 2-stage output is 256-dim")
        return TwinsEncoder()
    if kind == "cnn":
        return BasicEncoder(output_dim, norm)
    raise ValueError(f"encoder {kind!r}: expected 'twins' or 'cnn'")
