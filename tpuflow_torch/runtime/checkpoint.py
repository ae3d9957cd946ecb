"""The native checkpoint format (port of tpuflow/runtime/checkpoint.py).

The port reads and writes the JAX package's own file: the magic
b"tpuflow-params-v1\\n", then flax.serialization's msgpack of the flax param
tree ({'params': {...}}, flax names and layouts, float32).  A `.pth` converted
once then serves both packages:

    python3 -m tpuflow_torch.runtime.checkpoint MOF_sintel.pth MOF_sintel.msgpack
    engine.load_model("MOF_sintel.msgpack")

The port's side is a state dict with upstream names
(runtime/convert.py `flax_tree_from_state_dict` and `state_dict_from_jax`
map it), and msgpack is this module's own small codec of the subset flax
writes: maps with str keys, ints, bools, floats, str, bin, arrays, and the
ext types 1 (an array) and 3 (a numpy scalar), each the msgpack of (shape,
dtype name, C-order bytes), bfloat16 by name; leaves above 2^30 bytes go in
flax's chunked form.  Numeric leaves decode to numpy arrays, bfloat16 ones to
torch tensors (numpy has no bfloat16).
"""

from __future__ import annotations

import argparse
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from .convert import flax_tree_from_state_dict, state_dict_from_jax

MAGIC = b"tpuflow-params-v1\n"
NATIVE_SUFFIXES = (".msgpack", ".tpuflow")

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
MAX_CHUNK_BYTES = 2**30          # flax's MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


def is_native_checkpoint(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in NATIVE_SUFFIXES


# ---------------------------------------------------------------------------
# msgpack, the subset flax writes (encoded as msgpack-python's packb does)
# ---------------------------------------------------------------------------
def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else the 8/16/32-bit one
    (codes for those widths; a None code skips that width)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)) if v >= 0 else \
        ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15), (0xD2, ">i", 2**31), (0xD3, ">q", 2**63))
    for code, fmt, limit in forms:
        if (v < limit) if v >= 0 else (v >= -limit):
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} out of msgpack's range")


def _array_payload(x) -> bytes:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return packb([list(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()])
        x = x.numpy()
    return packb([list(x.shape), x.dtype.name, np.ascontiguousarray(x).tobytes()])


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int) and not isinstance(x, bool):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r}: flax writes str keys only")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor, np.generic)):
        data = _array_payload(np.asarray(x) if isinstance(x, np.generic) else x)
        code = _EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(code)
        out += data
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def packb(x: Any) -> bytes:
    out = bytearray()
    _pack(out, x)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _unpack(r: _Reader) -> Any:
    c = r.num(">B")
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        n = c & 0x0F if c <= 0x8F else r.num(_LENGTHS[c])
        return {_unpack(r): _unpack(r) for _ in range(n)}
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        n = c & 0x0F if c <= 0x9F else r.num(_LENGTHS[c])
        return [_unpack(r) for _ in range(n)]
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
        n = c & 0x1F if c <= 0xBF else r.num(_LENGTHS[c])
        return bytes(r.take(n)).decode("utf-8")
    if c in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.num(_LENGTHS[c])))
    if c in _FIXED_INTS:
        return r.num(_FIXED_INTS[c])
    if c in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[c]
    if c in (0xCA, 0xCB):
        return r.num(">f" if c == 0xCA else ">d")
    if 0xD4 <= c <= 0xD8 or c in (0xC7, 0xC8, 0xC9):
        n = 1 << (c - 0xD4) if c >= 0xD4 else r.num(_LENGTHS[c])
        code = r.num(">b")
        return _decode_ext(code, bytes(r.take(n)))
    raise ValueError(f"msgpack type byte 0x{c:02x} is not in the subset flax writes")


def _decode_ext(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not flax's array or scalar")
    shape, name, buf = unpackb(data)
    if name == "bfloat16":
        arr = torch.from_numpy(np.frombuffer(buf, np.int16).copy()).view(torch.bfloat16).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr.reshape(())
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _chunk_leaves(tree):
    """The tree as flax's msgpack_serialize lays it out: maps in sorted key
    order (its tree_map sorts them), leaves above MAX_CHUNK_BYTES in the
    chunked form (serialization._chunk), whose maps keep their order."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_BYTES:
        step = max(1, int(MAX_CHUNK_BYTES / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): flat[j : j + step] for i, j in enumerate(range(0, flat.size, step))}}
    return tree


def _unchunk_leaves(tree):
    if isinstance(tree, dict) and tree.get(_CHUNKED) is True:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    if isinstance(tree, dict):
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------
def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write the port's state dict as the JAX package's native checkpoint:
    the flax tree in float32 (as the JAX engine's params are), atomically
    (temp file + rename)."""
    blob = MAGIC + packb(_chunk_leaves(flax_tree_from_state_dict(state_dict)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def load_params(path: str, target: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """A native checkpoint -> the port's state dict (float32 CPU tensors,
    upstream names and layouts).  With `target` (a state dict, e.g. the
    model's), every name and shape must match it."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(
            f"{path} is not a tpuflow native checkpoint (bad header); "
            "torch .pth files go through runtime/convert.py instead"
        )
    flat = _flatten(_unchunk_leaves(unpackb(blob[len(MAGIC):])))
    # Writable copies: the decoded arrays view the file's bytes.
    flat = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.array(v)) for k, v in flat.items()}
    state = state_dict_from_jax(flat)
    if target is not None:
        missing, extra = sorted(set(target) - set(state)), sorted(set(state) - set(target))
        wrong = [k for k in set(state) & set(target) if tuple(state[k].shape) != tuple(target[k].shape)]
        if missing or extra or wrong:
            raise ValueError(f"{path} does not fit the model: missing {missing[:5]}, unexpected {extra[:5]}, "
                             f"other shapes {sorted(wrong)[:5]}")
    return state


def main(argv=None) -> int:
    """One-shot conversion: torch .pth -> native checkpoint.

    python3 -m tpuflow_torch.runtime.checkpoint IN.pth OUT.msgpack \\
        [--model videoflow|memflow] [--architecture mof|bof]
        [--encoder twins|cnn] [--stage sintel|things|kitti] [--device cuda|cpu]
    """
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--model", default="videoflow", choices=["videoflow", "memflow"])
    p.add_argument("--architecture", default="mof", choices=["mof", "bof"])
    p.add_argument("--encoder", default="twins", choices=["twins", "cnn"])
    p.add_argument("--stage", default="sintel", choices=["sintel", "things", "kitti"])
    p.add_argument("--device", default="cuda", help="where the model is built: cuda (default) or cpu")
    args = p.parse_args(argv)
    if not is_native_checkpoint(args.dst):
        p.error(
            f"dst must end in one of {NATIVE_SUFFIXES}: engine.load_model "
            "routes by suffix, so any other extension would be (mis)read "
            "as a torch checkpoint later"
        )

    from ..config import ModelConfig, memflow_stage_cfg
    from .engine import FlowEngine

    kw = {}
    if args.model == "memflow":
        kw.update(memflow_stage_cfg(args.stage))
    cfg = ModelConfig(
        model=args.model, architecture=args.architecture,
        encoder=args.encoder, stage=args.stage, **kw,
    )
    # f32: the .pth's weights are written unrounded.
    engine = FlowEngine(cfg, device=args.device, dtype=torch.float32)
    loaded = engine.load_model(args.src)
    save_params(args.dst, engine.model.state_dict())
    print(f"converted {loaded} -> {args.dst}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
