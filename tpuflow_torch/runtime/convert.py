"""Weights into the port: real VideoFlow and MemFlow `.pth` checkpoints, and
flax parameter trees of the JAX reference (for the parity tests).

The port's modules carry the upstream state-dict names, so a checkpoint
loads directly once `module.` prefixes and the tensors inference never
reads (VIDEOFLOW_IGNORE) are dropped.  A flax tree is mapped by inverting
the reference's name rewrite (tpuflow/runtime/convert.py
_rewrite_videoflow_key) with the table below, and its layouts converted:
conv kernels HWIO -> OIHW, Dense [in, out] -> [out, in], LayerNorm and
GroupNorm `scale` -> `weight`.  Twins encoders gain the upstream `.svt.`
scope; the cnn encoder's `layer{i}_{j}` become `layer{i}.{j}`.
`flax_tree_from_state_dict` is the inverse (the reference's rewrite itself),
which the native checkpoints of runtime/checkpoint.py are written with.

`describe_state_dict` and `suggest_mapping` (tpuflow/runtime/convert.py:237)
read a checkpoint against the port's own state-dict names: a shape report by
top-level module, and a greedy proposal of a name map for a checkpoint
whose names differ.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

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

# upstream torch module path -> flax module path (dotted): the reference's
# _rewrite_videoflow_key (tpuflow/runtime/convert.py:132), which its MemFlow
# table shares.
_TORCH_TO_FLAX = (
    (r"^(fnet|cnet)\.svt\.", r"\1."),
    (r"\.patch_embeds\.(\d+)\.", r".patch_embeds_\1."),
    (r"\.pos_block\.(\d+)\.proj\.0\.", r".pos_block_\1.proj_0."),
    (r"\.blocks\.(\d+)\.(\d+)\.", r".blocks_\1_\2."),
    (r"\.conv_list\.(\d+)\.", r".conv_list_\1."),
    (r"\.(ffn1|ffn2)\.(\d+)\.", r".\1_\2."),
    (r"\.mask\.(\d+)\.", r".mask_\1."),
    (r"\.layer(\d+)\.(\d+)\.", r".layer\1_\2."),
    (r"^update_block\.", "iteration.update_block."),
)


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
    """Flattened flax MOFNet, BOFNet or MemFlowNet params ('params/...'
    paths) -> the port's state dict (f32 CPU tensors, upstream names and
    layouts)."""
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


def flax_path_from_torch(key: str, ndim: int) -> str:
    """'fnet.svt.blocks.0.1.attn.kv.weight' (a tensor of `ndim` dims) ->
    'params/fnet/blocks_0_1/attn/kv/kernel'; a `weight` is a conv or dense
    `kernel` at 4 or 2 dims, else a norm's `scale`."""
    module, leaf = key.rsplit(".", 1)
    module += "."
    for pattern, repl in _TORCH_TO_FLAX:
        module = re.sub(pattern, repl, module)
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "params/" + module.rstrip(".").replace(".", "/") + "/" + leaf


def flax_tree_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The port's state dict (any dtype and device) -> the JAX package's
    param tree {'params': {...}} of float32 numpy arrays in flax layouts:
    the inverse of `state_dict_from_jax`, checked key by key."""
    tree: Dict = {}
    for key, val in state_dict.items():
        arr = val.detach().float().cpu().numpy()
        path = flax_path_from_torch(key, arr.ndim)
        if torch_key_from_flax(path) != key:
            raise ValueError(f"{key!r} has no flax name (rewritten to {path!r})")
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)              # OIHW -> HWIO
        elif leaf == "kernel" and arr.ndim == 2:
            arr = arr.T                                   # [out, in] -> [in, out]
        elif leaf == "init_hidden_state":
            arr = arr.reshape(1, 1, 1, 1, -1)             # channels-second -> last
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if parts[-1] in node:
            raise ValueError(f"two tensors map to {path!r}")
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def load_torch_state_dict(path: str, ignore: Sequence[str] = VIDEOFLOW_IGNORE) -> Dict[str, torch.Tensor]:
    """Read a VideoFlow or MemFlow `.pth` for the port: unwrap 'state_dict',
    strip the DataParallel `module.` prefix, drop the tensors that match a
    pattern of `ignore` (VIDEOFLOW_IGNORE, or convert_memflow.MEMFLOW_IGNORE)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if not any(re.search(p, k) for p in ignore):
            out[k] = v
    return out


def describe_state_dict(state_dict, max_rows: int = 0) -> str:
    """Shape report of a state dict (tensors or arrays), grouped by the
    first name component, as the JAX package's describe_state_dict prints
    it; `max_rows` > 0 lists at most that many tensors per group."""
    groups: Dict[str, list] = {}
    for k, v in state_dict.items():
        groups.setdefault(k.split(".")[0], []).append((k, tuple(v.shape)))
    lines, total = [], 0
    for g in sorted(groups):
        n_params = sum(int(np.prod(s)) for _, s in groups[g])
        total += n_params
        lines.append(f"[{g}] {len(groups[g])} tensors, {n_params / 1e6:.2f}M params")
        for k, s in groups[g][:max_rows] if max_rows else groups[g]:
            lines.append(f"  {k:<60} {s}")
    lines.append(f"TOTAL: {total / 1e6:.2f}M params, {len(state_dict)} tensors")
    return "\n".join(lines)


def suggest_mapping(state_dict, target) -> Dict[str, Optional[str]]:
    """Greedy proposal of a map from a checkpoint's names to the port's:
    each checkpoint tensor, in order, takes the unclaimed `target` name (a
    model's state dict, or {name: shape}) of its shape that shares the most
    name tokens with it, or None.  The port's modules keep the layouts of
    the upstream checkpoints, so shapes match as they are; a starting
    point for a hand-made table, never used to load."""

    def tokens(name: str) -> set:
        return set(name.replace(".", "/").replace("_", "/").lower().split("/"))

    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in target.items()}
    claimed, out = set(), {}
    for key, val in state_dict.items():
        cands = [k for k, s in shapes.items() if k not in claimed and s == tuple(val.shape)]
        if not cands:
            out[key] = None
            continue
        mine = tokens(key)
        best = max(cands, key=lambda k: len(mine & tokens(k)))
        claimed.add(best)
        out[key] = best
    return out
