"""ctypes bindings for the repository's native cache-IO runtime
(native/cacheio.cpp), as the JAX package's runtime/cacheio.py.

Builds the shared library with g++ -O3 on first use, into this package's
build/ directory, and falls back to the numpy implementations in
pipeline/cache.py when no compiler is available.  `AsyncFloWriter` writes
`.flo` files from a pool of native threads.  No pipeline or CLI path calls
this module: FlowPipeline writes its cache with FlowCacheManager (numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PACKAGE), "native", "cacheio.cpp")
_BUILD_DIR = os.path.join(_PACKAGE, "build")

_lib = None
_lib_lock = threading.Lock()


def _build() -> Optional[str]:
    """Compile the library into a path keyed by the source content hash —
    only a binary built from the checked-in source is ever loaded (no
    prebuilt .so can shadow a source edit or a review)."""
    with open(_SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f"libcacheio-{src_hash}.so")
    if os.path.exists(lib_path):
        return lib_path
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = lib_path + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, lib_path)  # atomic against concurrent builds
        return lib_path
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"[cacheio] native build unavailable ({e}); using numpy fallback")
        return None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        path = _build()
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(path)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.flo_write.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, f32p]
        lib.flo_write.restype = ctypes.c_int
        lib.flo_read_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)
        ]
        lib.flo_read_header.restype = ctypes.c_int
        lib.flo_read.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, f32p]
        lib.flo_read.restype = ctypes.c_int
        lib.lod_pyramid.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p]
        lib.lod_pyramid.restype = None
        lib.writer_pool_create.argtypes = [ctypes.c_int32]
        lib.writer_pool_create.restype = ctypes.c_void_p
        lib.writer_pool_enqueue.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, f32p
        ]
        lib.writer_pool_enqueue.restype = None
        lib.writer_pool_flush.argtypes = [ctypes.c_void_p]
        lib.writer_pool_errors.argtypes = [ctypes.c_void_p]
        lib.writer_pool_errors.restype = ctypes.c_int
        lib.writer_pool_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def _as_f32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_flo(path: str, flow: np.ndarray) -> None:
    """Native .flo write; numpy fallback keeps byte-identical output."""
    lib = load()
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    h, w = flow.shape[:2]
    if lib is None:
        from ..pipeline.cache import FlowFileHandler

        FlowFileHandler.save_flow_flo(flow, path)
        return
    rc = lib.flo_write(path.encode(), w, h, _as_f32_ptr(flow))
    if rc != 0:
        raise IOError(f"flo_write failed ({rc}): {path}")


def read_flo(path: str) -> np.ndarray:
    lib = load()
    if lib is None:
        from ..pipeline.cache import FlowFileHandler

        return FlowFileHandler.load_flow_flo(path)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.flo_read_header(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"Invalid .flo file: {path} (rc={rc})")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.flo_read(path.encode(), w.value, h.value, _as_f32_ptr(out))
    if rc != 0:
        raise IOError(f"flo_read failed ({rc}): {path}")
    return out


def lod_pyramid(flow: np.ndarray, num_lods: int = 5) -> List[np.ndarray]:
    """Native LOD pyramid; numerics match pipeline.cache.LODGenerator."""
    lib = load()
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    if lib is None:
        from ..pipeline.cache import LODGenerator

        return LODGenerator.generate_lods(flow, num_lods)
    h, w = flow.shape[:2]
    shapes = []
    ch, cw = h, w
    total = 0
    for _ in range(num_lods - 1):
        ch, cw = (ch + 1) // 2, (cw + 1) // 2
        shapes.append((ch, cw))
        total += ch * cw * 2
    buf = np.empty(total, np.float32)
    lib.lod_pyramid(_as_f32_ptr(flow), h, w, num_lods, _as_f32_ptr(buf))
    lods = [flow]
    off = 0
    for ch, cw in shapes:
        n = ch * cw * 2
        lods.append(buf[off : off + n].reshape(ch, cw, 2).copy())
        off += n
    return lods


class AsyncFloWriter:
    """Thread-pool .flo writer; falls back to synchronous numpy writes."""

    def __init__(self, n_threads: int = 4):
        self._lib = load()
        self._pool = (
            self._lib.writer_pool_create(n_threads) if self._lib is not None else None
        )

    def write(self, path: str, flow: np.ndarray) -> None:
        flow = np.ascontiguousarray(flow, dtype=np.float32)
        if self._pool is None:
            write_flo(path, flow)
            return
        h, w = flow.shape[:2]
        self._lib.writer_pool_enqueue(self._pool, path.encode(), w, h, _as_f32_ptr(flow))

    def flush(self) -> int:
        """Wait for pending writes; returns the error count."""
        if self._pool is None:
            return 0
        self._lib.writer_pool_flush(self._pool)
        return self._lib.writer_pool_errors(self._pool)

    def close(self) -> None:
        if self._pool is not None:
            self._lib.writer_pool_flush(self._pool)
            self._lib.writer_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self) -> "AsyncFloWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
