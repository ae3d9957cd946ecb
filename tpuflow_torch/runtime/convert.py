"""Weights into the port: real VideoFlow `.pth` checkpoints, and flax
parameter trees of the JAX reference (for the parity tests).

The port's modules carry the upstream state-dict names, so a checkpoint
loads directly once `module.` prefixes and the tensors inference never
reads (VIDEOFLOW_IGNORE) are dropped.  A flax tree is mapped by inverting
the reference's name rewrite (tpuflow/runtime/convert.py
_rewrite_videoflow_key) with the table below, and its layouts converted:
conv kernels HWIO -> OIHW, Dense [in, out] -> [out, in], LayerNorm and
GroupNorm `scale` -> `weight`.  Twins encoders gain the upstream `.svt.`
scope; the cnn encoder's `layer{i}_{j}` become `layer{i}.{j}`.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# Checkpoint tensors with no counterpart in the inference net, by design.
VIDEOFLOW_IGNORE = (
    r"^(fnet|cnet)\.svt\.(blocks|patch_embeds|pos_block|pos_drops)\.[23]\.",  # twins stages 3-4
    r"^(fnet|cnet)\.svt\.(head|norm)\.",       # classifier head
    r"^att\.pos_emb\.",                        # RelPosEmb (content-only attention)
    r"\.num_batches_tracked$",
    r"^update_block\.aggregator\.pos_emb\.",
)

# flax module path (dotted) -> upstream torch module path: the inverse of
# the reference's _rewrite_videoflow_key (Twins, cnn encoder, SK update block).
_FLAX_TO_TORCH = (
    (r"^iteration\.update_block\.", "update_block."),
    (r"^(fnet|cnet)\.(?=(patch_embeds|pos_block|blocks)_)", r"\1.svt."),
    (r"\.layer(\d+)_(\d+)\.", r".layer\1.\2."),
    (r"\.patch_embeds_(\d+)\.", r".patch_embeds.\1."),
    (r"\.pos_block_(\d+)\.proj_0\.", r".pos_block.\1.proj.0."),
    (r"\.blocks_(\d+)_(\d+)\.", r".blocks.\1.\2."),
    (r"\.conv_list_(\d+)\.", r".conv_list.\1."),
    (r"\.(ffn1|ffn2)_(\d+)\.", r".\1.\2."),
    (r"\.mask_(\d+)\.", r".mask.\1."),
)

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def torch_key_from_flax(path: str) -> str:
    """'params/fnet/blocks_0_1/attn/kv/kernel' -> 'fnet.svt.blocks.0.1.attn.kv.weight'."""
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    module = ".".join(parts[:-1]) + "."
    for pattern, repl in _FLAX_TO_TORCH:
        module = re.sub(pattern, repl, module)
    return module + _LEAF_NAMES.get(parts[-1], parts[-1])


def state_dict_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax MOFNet params ('params/...' paths) -> the port's state
    dict (f32 CPU tensors, upstream names and layouts)."""
    out = {}
    for path, val in flat.items():
        val = np.asarray(val, dtype=np.float32)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel" and val.ndim == 4:
            val = val.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        elif leaf == "kernel" and val.ndim == 2:
            val = val.T                                   # [in, out] -> [out, in]
        elif leaf == "init_hidden_state":
            val = val.reshape(1, 1, -1, 1, 1)             # channels-last -> second
        out[torch_key_from_flax(path)] = torch.from_numpy(np.ascontiguousarray(val))
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a VideoFlow `.pth` for the port: unwrap 'state_dict', strip the
    DataParallel `module.` prefix, drop the VIDEOFLOW_IGNORE tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if not any(re.search(p, k) for p in VIDEOFLOW_IGNORE):
            out[k] = v
    return out
