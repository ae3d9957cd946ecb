"""tpuflow_torch: the PyTorch + CUDA port of tpuflow for NVIDIA Hopper.

The JAX package `tpuflow` is the reference; this package mirrors its module
names (core/, kernels/, runtime/) and keeps its public layouts (frames
[N, H, W, 3], flows [..., 2]).  It imports torch, numpy and the standard
library only.  The hand-written CUDA kernels live in `csrc/` and are built
with nvcc at first use (kernels/_build.py).

Entry points: `runtime.engine.FlowEngine` and `runtime.engine.build_model`.
"""

from .config import ModelConfig

__all__ = ["ModelConfig"]
