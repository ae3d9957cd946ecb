"""tpuflow_torch: the PyTorch + CUDA port of tpuflow for NVIDIA Hopper.

The JAX package `tpuflow` is the reference; this package mirrors its module
names (core/, kernels/, runtime/, pipeline/, tools/) and keeps its public
layouts (frames [N, H, W, 3], flows [..., 2]) and its cache and output
file names.  It imports torch, numpy, the standard library, cv2 (video IO
and composition) and optionally tqdm.  The hand-written CUDA kernels live
in `csrc/` and are built with nvcc at first use (kernels/_build.py).

Entry points: `runtime.engine.FlowEngine`, `runtime.engine.build_model`,
`tools.pipeline.FlowPipeline` and the CLI, `python3 -m
tpuflow_torch.tools.cli` (with `--interactive`, the visualizer of
`tools/visualizer.py` over the correction engine of `tools/correction.py`),
the GUI launcher `python3 -m tpuflow_torch.tools.gui`, and the legacy
`compat.VideoFlowInference` / `MemFlowInference` API.
"""

from .config import ModelConfig

# Everything but ModelConfig loads on first use, so that importing the
# package pulls in neither cv2 nor the engine.
__all__ = ["ModelConfig", "PipelineConfig", "FlowEngine", "FlowPipeline", "VideoFlowInference", "MemFlowInference"]


def __getattr__(name):
    if name == "PipelineConfig":
        from .config import PipelineConfig

        return PipelineConfig
    if name == "FlowEngine":
        from .runtime.engine import FlowEngine

        return FlowEngine
    if name == "FlowPipeline":
        from .tools.pipeline import FlowPipeline

        return FlowPipeline
    if name in ("VideoFlowInference", "MemFlowInference"):
        from . import compat

        return getattr(compat, name)
    raise AttributeError(f"module 'tpuflow_torch' has no attribute {name!r}")
