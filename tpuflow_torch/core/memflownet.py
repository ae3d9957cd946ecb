"""MemFlowNet: streaming two-frame optical flow with a motion memory (port of
tpuflow/core/memflownet.py).

Call with a frame pair [B, 2, H, W, 3] in [0, 1] (previous frame, this
frame) and a MemoryState; returns (flow [B, H, W, 2], the new memory,
flow at 1/8 resolution [B, H/8, W/8, 2]).

- fnet on both frames, cnet on the previous one (core/encoders.py);
  net = tanh, inp = relu of the context.
- att: GMA q/k over the context.  Where b*hw*hw bf16 probabilities take at
  most `attn_materialize_bytes`, they are computed once per frame
  (gma.materialize_attention) and each iteration applies them with one
  product; above it every iteration launches kernel K2.
- The correlation of the pair from `make_corr` (a dense pyramid read by
  kernel K1 up to 168x168 feature grids, FlashCorr2 with kernel K3 above).
- The memory: keys are projections of the context (qk_proj), values of the
  last iteration's motion features (v_proj).  One readout per frame
  (MemoryReader: exact softmax over every valid (slot, position) token,
  optionally with 2D rotary positions; kernel K9 on the card) joins the
  motion encoder's input on every iteration.
- decoder_depth steps of SKUpdateBlockMem, then the convex 8x upsample with
  the last step's mask.

The memory is a fixed-capacity ring with a validity mask, carried by the
caller across a clip (runtime/engine.py stream_flows).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..kernels.memread import memory_read_stage, rope_rotate, rope_table
from ..runtime.profiling import span
from .corr import DENSE_LOOKUP_IMPLS, MATERIALIZE_THRESHOLD, DenseCorrPyramid, make_corr
from .encoders import make_encoder
from .gma import Attention, conv1x1, materialize_attention
from .mofnet import encode_chunked
from .sk import SKUpdateBlockMem
from .update import upsample_flow_convex

# Largest GMA probability matrix, b*hw*hw*2 bytes, that a frame materializes
# (tpuflow/core/memflownet.py:330).
ATTN_MATERIALIZE_BYTES = 10**9

# Bound on the tokens the memory carries from frame to frame, and on a
# warm-started flow: with arbitrary weights the memory -> motion cycle can
# grow without bound over a long stream; trained weights keep tokens O(10).
CARRY_CLAMP = 1.0e4


class MemoryState(NamedTuple):
    """Ring buffer of per-position keys (context) and values (motion).

    keys:   [B, cap, h*w, dk] f32
    values: [B, cap, h*w, dv] f32
    valid:  [B, cap]  1.0 where the slot holds a frame
    ptr:    [B]       int64, the next write slot (mod cap)
    """

    keys: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    ptr: torch.Tensor


def init_memory(
    batch: int, capacity: int, hw: int, key_dim: int, value_dim: int,
    dtype: torch.dtype = torch.float32, device=None,
) -> MemoryState:
    return MemoryState(
        keys=torch.zeros((batch, capacity, hw, key_dim), dtype=dtype, device=device),
        values=torch.zeros((batch, capacity, hw, value_dim), dtype=dtype, device=device),
        valid=torch.zeros((batch, capacity), dtype=dtype, device=device),
        ptr=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def memory_write(mem: MemoryState, key: torch.Tensor, value: torch.Tensor) -> MemoryState:
    """Writes key [B, hw, dk] and value [B, hw, dv], cast to the memory's
    dtype and clamped to +-CARRY_CLAMP, into slot ptr % cap of each batch
    row, marks the slot valid and advances ptr.  Returns a new MemoryState;
    `mem` is left as it was.  The reference blends every slot with a one-hot
    of the slot, which for finite entries is this one write."""
    b, cap = mem.valid.shape
    rows = torch.arange(b, device=mem.ptr.device)
    slot = mem.ptr % cap
    keys, values, valid = mem.keys.clone(), mem.values.clone(), mem.valid.clone()
    keys[rows, slot] = key.to(keys.dtype).clamp(-CARRY_CLAMP, CARRY_CLAMP)
    values[rows, slot] = value.to(values.dtype).clamp(-CARRY_CLAMP, CARRY_CLAMP)
    valid[rows, slot] = valid.new_ones(())     # a device value: a host scalar's copy would wait for the card
    return MemoryState(keys, values, valid, mem.ptr + 1)


def rope_2d(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """2D rotary position embedding over a flattened [..., h*w, d] token
    axis, in f32: the first d/2 channels rotate with the x coordinate, the
    second d/2 with y.  Within each half, channel i of the first quarter
    pairs with channel i of the second (no interleaving), rotated by
    pos * 10000^(-i / (d/4)) (kernels/memread.py rope_table, rope_rotate)."""
    return rope_rotate(t, rope_table(h, w, t.shape[-1], t.device))


class MemoryReader(nn.Module):
    """Cross-attention of this frame's context key over every (slot,
    position) token of the memory, then `out_proj` (1x1 conv to 128
    channels).

    In f32: q is scaled by dk^-1/2, then q and the keys are rotated
    (use_rope); the softmax runs over the valid slots' tokens; a batch row
    with no valid slot reads zeros.  Kernel K9 (kernels/memread.py) on the
    card, its plain twin on the CPU; the rotary table is built once per
    grid and device.
    """

    def __init__(self, value_dim: int = 128, use_rope: bool = False):
        super().__init__()
        self.use_rope = use_rope
        self.out_proj = nn.Conv2d(value_dim, 128, 1)
        self._tables: dict = {}

    def rope_table(self, h: int, w: int, dk: int, device) -> torch.Tensor:
        """The rotary table [h*w, 2, dk/2] for this grid, built once per
        (h, w, dk, device)."""
        key = (h, w, dk, torch.device(device))
        table = self._tables.get(key)
        if table is None:
            # An ordinary tensor even when built under inference mode: a
            # later backward through the reader saves it.
            with torch.inference_mode(False):
                table = self._tables[key] = rope_table(h, w, dk, device)
        return table

    @span("tpuflow.memflow.read")
    def forward(self, query: torch.Tensor, mem: MemoryState) -> torch.Tensor:
        """query [B, h, w, dk] -> readout [B, h, w, 128] in query's dtype."""
        b, h, w, dk = query.shape
        table = self.rope_table(h, w, dk, query.device) if self.use_rope else None
        read = memory_read_stage(query.reshape(b, h * w, dk), mem.keys, mem.values, mem.valid, table)
        return conv1x1(read.reshape(b, h, w, -1).to(query.dtype), self.out_proj)


class MemEncoded(NamedTuple):
    """What the readout and the refinement read, from `MemFlowNet.encode`."""

    net: torch.Tensor             # [B, h, w, hidden] initial hidden state
    inp: torch.Tensor             # [B, h, w, context] context
    q: torch.Tensor               # [B, h, w, 128] GMA query (pre-scaled)
    k: torch.Tensor               # [B, h, w, 128] GMA key
    attn: Optional[torch.Tensor]  # [B, hw, hw] GMA probabilities, or None (K2)
    corr: Any                     # the pair's correlation object
    qk: torch.Tensor              # [B, h, w, dk] memory key and readout query


class MemFlowNet(nn.Module):
    def __init__(
        self,
        corr_levels: int = 4,
        corr_radius: int = 4,
        decoder_depth: int = 12,
        feature_dim: int = 256,
        hidden_dim: int = 128,
        context_dim: int = 128,
        key_dim: int = 64,
        value_dim: int = 128,
        memory_capacity: int = 8,
        encoder: str = "twins",
        use_rope: bool = False,
        corr_dtype: torch.dtype = torch.bfloat16,
        corr_impl: str = "auto",
        dense_lookup: str = "auto",
    ):
        """`corr_impl` and `dense_lookup`: as MOFNet's."""
        super().__init__()
        if dense_lookup not in DENSE_LOOKUP_IMPLS:
            raise ValueError(f"dense_lookup {dense_lookup!r}: expected one of {DENSE_LOOKUP_IMPLS}")
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.decoder_depth = decoder_depth
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.key_dim, self.value_dim = key_dim, value_dim
        self.memory_capacity = memory_capacity
        self.corr_dtype = corr_dtype
        self.corr_impl = corr_impl
        self.dense_lookup = dense_lookup
        # Parity runs lower these to reach the large-grid routes on a small
        # frame: FlashCorr2 (K3) and GMA without materialized probabilities
        # (K2).
        self.materialize_threshold = MATERIALIZE_THRESHOLD
        self.attn_materialize_bytes = ATTN_MATERIALIZE_BYTES
        self.fnet = make_encoder(encoder, feature_dim, "instance")
        self.cnet = make_encoder(encoder, hidden_dim + context_dim, "batch")
        self.att = Attention(dim=context_dim, dim_head=context_dim)
        self.update_block = SKUpdateBlockMem(corr_levels, corr_radius, hidden_dim, value_dim=value_dim)
        self.qk_proj = nn.Conv2d(context_dim, key_dim, 1)
        self.v_proj = nn.Conv2d(128, value_dim, 1)
        self.memory_reader = MemoryReader(value_dim, use_rope)

    @property
    def dtype(self) -> torch.dtype:
        return self.att.to_qk.weight.dtype

    def empty_memory(self, batch: int, h: int, w: int) -> MemoryState:
        """An empty memory for frames of h x w pixels, on the model's device."""
        return init_memory(
            batch, self.memory_capacity, (h // 8) * (w // 8), self.key_dim, self.value_dim,
            device=self.att.to_qk.weight.device,
        )

    def _lookup(self, corr, flow: torch.Tensor) -> torch.Tensor:
        if isinstance(corr, DenseCorrPyramid):
            return corr.lookup(flow, self.corr_radius, impl=self.dense_lookup)
        return corr.lookup(flow, self.corr_radius)

    @span("tpuflow.memflow.encode")
    def encode(self, frame_pair: torch.Tensor) -> MemEncoded:
        """frame_pair [B, 2, H, W, 3] in [0, 1] -> what the readout and the
        refinement read: fnet on both frames, cnet on frame 0."""
        b, _, h, w, _ = frame_pair.shape
        h8, w8 = h // 8, w // 8
        hw = h8 * w8
        x = (2.0 * frame_pair - 1.0).to(self.dtype)
        feats = encode_chunked(self.fnet, x.reshape(b * 2, h, w, 3)).reshape(b, 2, h8, w8, -1)
        ctx = encode_chunked(self.cnet, x[:, 0])
        net = torch.tanh(ctx[..., : self.hidden_dim])
        inp = torch.relu(ctx[..., self.hidden_dim :])
        q, k = self.att(inp)
        attn = materialize_attention(q, k, self.dtype) if b * hw * hw * 2 <= self.attn_materialize_bytes else None
        corr = make_corr(
            feats[:, 0].to(self.corr_dtype), feats[:, 1].to(self.corr_dtype), self.corr_levels,
            impl=self.corr_impl, materialize_threshold=self.materialize_threshold,
        )
        return MemEncoded(net, inp, q, k, attn, corr, conv1x1(inp, self.qk_proj))

    @span("tpuflow.memflow.refine")
    def refine(
        self, enc: MemEncoded, mem_read: torch.Tensor, flow_init: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """decoder_depth update steps with the memory readout mem_read [B, h,
        w, 128], from flow_init [B, h, w, 2] or zeros -> (flow [B, H, W, 2],
        flow_low [B, h, w, 2], the last step's motion features [B, h, w,
        128])."""
        b, h8, w8, _ = enc.net.shape
        dev = enc.net.device
        flow = torch.zeros((b, h8, w8, 2), dtype=torch.float32, device=dev) if flow_init is None else flow_init.float()
        net = enc.net
        motion = torch.zeros((b, h8, w8, 128), dtype=self.dtype, device=dev)
        for _ in range(self.decoder_depth):
            cf = self._lookup(enc.corr, flow).to(self.dtype)
            net, motion, delta = self.update_block.step(net, enc.inp, cf, flow, enc.q, enc.k, mem_read, enc.attn)
            flow = flow + delta.float()
        # Only the last step's mask is read, so the mask head runs once.
        mask = self.update_block.upsample_mask(net).float()
        return upsample_flow_convex(flow, mask), flow, motion

    def forward(
        self, frame_pair: torch.Tensor, memory: MemoryState, flow_init: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, MemoryState, torch.Tensor]:
        enc = self.encode(frame_pair)
        flow_up, flow_low, motion = self.refine(enc, self.memory_reader(enc.qk, memory), flow_init)
        return flow_up, self.write(memory, enc.qk, motion), flow_low

    @span("tpuflow.memflow.write")
    def write(self, memory: MemoryState, qk: torch.Tensor, motion: torch.Tensor) -> MemoryState:
        """This frame's key qk [B, h, w, dk] and the value projected from the
        last step's motion features [B, h, w, 128], written to the memory."""
        b, h8, w8, _ = qk.shape
        value = conv1x1(motion, self.v_proj)
        return memory_write(
            memory, qk.reshape(b, h8 * w8, self.key_dim), value.reshape(b, h8 * w8, self.value_dim)
        )
