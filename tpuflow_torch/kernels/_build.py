"""Build the CUDA sources in ../csrc with nvcc at first use and load them
with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so`, where the hash
covers the source, the shared headers and the flags, so an edited source is
never served from a stale library.  `build()` starts one nvcc per missing
library, all at once, and waits for them; `library(name)` builds on demand
and loads.  Nothing is compiled or loaded at import: the CPU tests import
every module.

`checked=True` selects the bounds-checked build: the same sources with
-DTPUFLOW_BOUNDS_CHECK (every global load and store guarded, a trap on a
miss; csrc/bounds.cuh) and -lineinfo, in libraries of their own.  A process
that calls `serve_checked()` before its first launch gets the checked
libraries in every wrapper.  A trap poisons the process's CUDA context, so
such a run belongs in a process of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("dense_lookup", "flash_attention", "corr_patch", "volume_patch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
CHECKED_FLAGS = ("-DTPUFLOW_BOUNDS_CHECK", "-lineinfo")

_libs: Dict[Tuple[str, bool], ctypes.CDLL] = {}
_lock = threading.Lock()
_serve_checked = False


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled on first use and "
        "need the CUDA toolkit (PATH or /usr/local/cuda/bin)."
    )


def _flags(checked: bool) -> Tuple[str, ...]:
    return NVCC_FLAGS + CHECKED_FLAGS if checked else NVCC_FLAGS


def library_path(name: str, checked: bool = False) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(_flags(checked)).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}{'-checked' if checked else ''}-{digest}.so"


def build(names: Iterable[str] = SOURCES, checked: bool = False) -> Dict[str, str]:
    """Compile every listed source whose library is missing, one nvcc per
    source, all started together (`checked`: the bounds-checked build).
    Returns {name: compiler output} for the sources compiled now (ptxas
    register and spill report included)."""
    jobs: list[Tuple[str, subprocess.Popen, Path, Path]] = []
    for name in names:
        so = library_path(name, checked)
        if so.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(checked), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def serve_checked() -> None:
    """From now on, `library(name)` in this process serves the bounds-checked
    build (to every wrapper)."""
    global _serve_checked
    _serve_checked = True


def library(name: str, checked: Optional[bool] = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing;
    `checked` selects the bounds-checked build (default: the build that
    serve_checked chose, else the fast one)."""
    checked = _serve_checked if checked is None else checked
    with _lock:
        lib = _libs.get((name, checked))
        if lib is None:
            build([name], checked)
            lib = ctypes.CDLL(str(library_path(name, checked)))
            _libs[(name, checked)] = lib
        return lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
