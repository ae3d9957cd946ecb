"""Build the CUDA sources in ../csrc with nvcc at first use and load them
with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so`, where the hash
covers the source and the flags, so an edited source is never served from
a stale library.  `build()` starts one nvcc per missing library, all at
once, and waits for them; `library(name)` builds on demand and loads.
Nothing is compiled or loaded at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("dense_lookup", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled on first use and "
        "need the CUDA toolkit (PATH or /usr/local/cuda/bin)."
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source whose library is missing, one nvcc per
    source, all started together.  Returns {name: compiler output} for the
    sources compiled now (ptxas register and spill report included)."""
    jobs: list[Tuple[str, subprocess.Popen, Path, Path]] = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, so))
    logs: Dict[str, str] = {}
    errors = []
    for name, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            errors.append(f"--- {name} (exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
