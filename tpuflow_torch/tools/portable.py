"""Portable distribution builder (the JAX package's tools/portable.py for
the port).

The reference ships a Windows portable builder (create_portable.py:287:
embedded CPython + pip + torch cu118, app copy, .bat launchers).  This one
targets Linux hosts with an NVIDIA card: it packages `tpuflow_torch/` (its
CUDA sources in `csrc/` included, its `build/` left out), the native
cache-IO sources, launcher scripts and a venv bootstrap that installs
PyTorch and the rest, into a self-contained directory (and optionally a
tarball).  The CUDA kernels are compiled with `nvcc` at first use, so the
host needs the CUDA toolkit.
"""

from __future__ import annotations

import os
import shutil
import stat
import sys
import tarfile
from pathlib import Path
from typing import Optional

EXCLUDE_DIRS = {".git", "__pycache__", ".pytest_cache", "build"}
EXCLUDE_SUFFIXES = {".pyc", ".so", ".avi", ".mp4", ".npz", ".flo"}

REQUIREMENTS = """\
torch
numpy
opencv-python-headless
tqdm
pillow
"""

SETUP_SH = """\
#!/usr/bin/env bash
# Bootstrap a self-contained environment for tpuflow_torch.
set -euo pipefail
cd "$(dirname "$0")"
python3 -m venv .venv
.venv/bin/pip install --upgrade pip
.venv/bin/pip install -r requirements.txt
# The CUDA kernels (tpuflow_torch/csrc) are compiled with nvcc at first use,
# and the native cache IO (native/cacheio.cpp) with g++.
if ! command -v nvcc >/dev/null && [ ! -x /usr/local/cuda/bin/nvcc ]; then
  echo "Warning: nvcc not found; install the CUDA toolkit before the first run on the card."
fi
echo "Setup complete. Run ./run_cli.sh --help"
"""

RUN_CLI_SH = """\
#!/usr/bin/env bash
cd "$(dirname "$0")"
exec .venv/bin/python -m tpuflow_torch.tools.cli "$@"
"""

RUN_GUI_SH = """\
#!/usr/bin/env bash
cd "$(dirname "$0")"
exec .venv/bin/python -m tpuflow_torch.tools.gui "$@"
"""

CHECK_SH = """\
#!/usr/bin/env bash
cd "$(dirname "$0")"
exec .venv/bin/python chip_smoke.py "$@"
"""


class PortableBuilder:
    """Assemble a portable tpuflow_torch distribution (create_portable.py
    parity, Linux and CUDA edition)."""

    def __init__(self, repo_root: Optional[str] = None, output_dir: str = "tpuflow_portable_cuda"):
        self.repo_root = Path(
            repo_root
            or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        )
        self.output_dir = Path(output_dir)

    def _should_copy(self, path: Path) -> bool:
        for part in path.parts:
            if part in EXCLUDE_DIRS:
                return False
        return path.suffix not in EXCLUDE_SUFFIXES

    def copy_app(self) -> None:
        for rel in ["tpuflow_torch", "native"]:
            src = self.repo_root / rel
            if not src.exists():
                continue
            for f in src.rglob("*"):
                if f.is_file() and self._should_copy(f.relative_to(self.repo_root)):
                    dst = self.output_dir / f.relative_to(self.repo_root)
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    shutil.copy2(f, dst)
        for f in ["chip_smoke.py", "README.md"]:
            src = self.repo_root / f
            if src.exists():
                shutil.copy2(src, self.output_dir / f)

    def write_launchers(self) -> None:
        scripts = {
            "setup.sh": SETUP_SH,
            "run_cli.sh": RUN_CLI_SH,
            "run_gui.sh": RUN_GUI_SH,
            "check_gpu.sh": CHECK_SH,
        }
        for name, content in scripts.items():
            path = self.output_dir / name
            path.write_text(content)
            path.chmod(path.stat().st_mode | stat.S_IEXEC | stat.S_IXGRP | stat.S_IXOTH)
        (self.output_dir / "requirements.txt").write_text(REQUIREMENTS)

    def build(self, tarball: bool = False) -> str:
        if self.output_dir.exists():
            shutil.rmtree(self.output_dir)
        self.output_dir.mkdir(parents=True)
        self.copy_app()
        self.write_launchers()
        print(f"Portable distribution assembled at: {self.output_dir}")
        if tarball:
            tar_path = str(self.output_dir) + ".tar.gz"
            with tarfile.open(tar_path, "w:gz") as tar:
                tar.add(self.output_dir, arcname=self.output_dir.name)
            print(f"Tarball: {tar_path}")
            return tar_path
        return str(self.output_dir)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Build a portable tpuflow_torch distribution")
    parser.add_argument("--output", default="tpuflow_portable_cuda")
    parser.add_argument("--tarball", action="store_true")
    args = parser.parse_args()
    PortableBuilder(output_dir=args.output).build(tarball=args.tarball)
    return 0


if __name__ == "__main__":
    sys.exit(main())
