"""Legacy-API compatibility layer (the JAX package's compat.py over the
port's FlowEngine).

Drop-in equivalents of the reference's engine classes so code written
against `processing/` imports ports mechanically:

  VideoFlowInference  <- processing/flow_inference.py:24 (delegation
                         wrapper incl. `.model`/`.cfg` legacy attrs :66-72)
  MemFlowInference    <- processing/memflow_inference.py:20
  VideoFlowProcessor / MemFlowProcessor level methods
                      <- processing/videoflow_processor.py /
                         memflow_processor.py (prepare_frame_sequence,
                         compute_optical_flow, compute_optical_flow_tiled,
                         calculate_tile_grid, validate_frames, ...)

All compute routes through tpuflow_torch.runtime.engine.FlowEngine, on the
device that `device` names through DeviceManager ('auto' and 'cuda' = the
card, 'cpu'); arrays in and out are numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .config import ModelConfig, TILE_SIZE
from .runtime.device import DeviceManager
from .runtime.engine import FlowEngine
from .runtime.tiles import calculate_tile_grid as _calc_tile_grid, extract_tile as _extract_tile
from .runtime.windows import centered_window_indices, trailing_window_indices


class _BaseInference:
    """Shared engine-backed implementation of the legacy 3-tier API
    (processing/__init__.py:10-21 documents the Core/Processor/Inference
    pattern; here a single class serves all three tiers)."""

    model_kind = "videoflow"

    def __init__(
        self,
        device="auto",
        fast_mode=False,
        tile_mode=False,
        sequence_length=5,
        dataset="sintel",
        architecture="mof",
        variant="standard",
        stage="sintel",
        model_path=None,
        engine: Optional[FlowEngine] = None,
        allow_random_init=False,
    ):
        self.device = device
        self.fast_mode = fast_mode
        self.tile_mode = tile_mode
        self.sequence_length = sequence_length
        self.dataset = dataset
        self.architecture = architecture
        self.variant = variant
        self.stage = stage
        self.model_path = model_path
        self.allow_random_init = allow_random_init

        cfg = ModelConfig(
            model=self.model_kind,
            architecture=architecture,
            dataset=dataset,
            variant=variant,
            stage=stage,
            fast_mode=fast_mode,
            sequence_length=max(2, sequence_length)
            if self.model_kind == "memflow"
            else sequence_length,
        )
        self.engine = engine or FlowEngine(cfg, device=DeviceManager.get_device(device))

    # -- lifecycle ---------------------------------------------------------
    def load_model(self):
        path = self.engine.load_model(
            self.model_path, allow_random_init=self.allow_random_init
        )
        print(f"{type(self).__name__}: model ready ({path})")
        return path

    def is_model_loaded(self) -> bool:
        return self.engine.is_model_loaded()

    # -- legacy attributes (flow_inference.py:66-72) -------------------------
    @property
    def model(self):
        return self.engine.model

    @property
    def cfg(self):
        return self.engine.config

    @property
    def core(self):
        return self.engine

    # -- window/tile helpers --------------------------------------------------
    def calculate_tile_grid(self, width, height, tile_size=TILE_SIZE):
        return _calc_tile_grid(width, height, tile_size)

    def extract_tile(self, frame, tile_info):
        return _extract_tile(frame, tile_info)

    def prepare_frame_sequence(self, frames: Sequence[np.ndarray], frame_idx: int) -> np.ndarray:
        """Window as [1, T, 3, H, W] float32 in [0,1] — the reference's
        tensor contract (videoflow_processor.py:122-162), numpy edition."""
        n = len(frames)
        if self.model_kind == "memflow":
            idx = trailing_window_indices(n, frame_idx, max(2, self.sequence_length))
        else:
            idx = centered_window_indices(n, frame_idx, self.sequence_length)
        window = np.asarray(frames)[idx]
        # Branch on dtype, not data: uint8 always scales by 255 (the
        # reference's unconditional /255.0, videoflow_processor.py:149-152);
        # float inputs pass through.
        if window.dtype == np.uint8:
            window = window.astype(np.float32) / 255.0
        else:
            window = window.astype(np.float32)
        return window.transpose(0, 3, 1, 2)[None]  # [1, T, 3, H, W]

    def validate_frames(self, frames, frame_idx) -> None:
        """Input validation (videoflow_processor.py:307-351)."""
        if not isinstance(frames, (list, tuple, np.ndarray)):
            raise ValueError("Frames must be a list of numpy arrays")
        if len(frames) == 0:
            raise ValueError("Frames list cannot be empty")
        if frame_idx < 0 or frame_idx >= len(frames):
            raise ValueError(
                f"Frame index {frame_idx} out of range [0, {len(frames) - 1}]"
            )
        sample = frames[0]
        if not isinstance(sample, np.ndarray):
            raise ValueError("Frames must be numpy arrays")
        if sample.ndim != 3 or sample.shape[2] != 3:
            raise ValueError(f"Frames must be [H,W,3] arrays, got {sample.shape}")
        if sample.dtype not in (np.uint8, np.float32, np.float64):
            raise ValueError(f"Unsupported frame dtype: {sample.dtype}")

    def set_tile_mode(self, enabled: bool) -> None:
        self.tile_mode = enabled

    def set_sequence_length(self, length: int) -> None:
        if length < 1 or length > 10:
            raise ValueError("Sequence length must be between 1 and 10")
        self.sequence_length = length

    # -- compute ----------------------------------------------------------------
    def compute_optical_flow(self, frames: Sequence[np.ndarray], frame_idx: int) -> np.ndarray:
        self.validate_frames(frames, frame_idx)
        return self.engine.compute_flow(frames, frame_idx)

    def compute_optical_flow_with_progress(self, frames, frame_idx, tile_pbar=None):
        return self.compute_optical_flow(frames, frame_idx)

    def compute_optical_flow_tiled(
        self, frames, frame_idx, tile_pbar=None, overall_pbar=None
    ) -> np.ndarray:
        if not self.tile_mode:
            return self.compute_optical_flow(frames, frame_idx)
        return self.engine.compute_flow_tiled(frames, frame_idx)

    # -- introspection -----------------------------------------------------------
    def get_model_info(self) -> dict:
        info = self.engine.get_model_info()
        if info.get("status") == "loaded":
            info.update(
                tile_mode=self.tile_mode,
                sequence_length=self.sequence_length,
                processor_type=type(self).__name__,
            )
        return info

    def get_memory_usage(self) -> dict:
        return self.engine.get_memory_usage()

    def get_device(self):
        """The engine's torch.device."""
        return self.engine.device


class VideoFlowInference(_BaseInference):
    """Engine API the orchestrator consumes for VideoFlow
    (flow_inference.py:24; selected at flow_processor.py:64-90)."""

    model_kind = "videoflow"


class MemFlowInference(_BaseInference):
    """MemFlow twin (memflow_inference.py:20).  Adds the streaming entry
    the reference never had (its per-frame subprocess reset the memory,
    SURVEY §3.3)."""

    model_kind = "memflow"

    def stream_flows(self, frames, warm_start: bool = False) -> np.ndarray:
        return self.engine.stream_flows(frames, warm_start=warm_start)


# Processor-tier aliases: the reference splits Core/Processor/Inference;
# the engine-backed class covers all three surfaces.
VideoFlowProcessor = VideoFlowInference
MemFlowProcessor = MemFlowInference
