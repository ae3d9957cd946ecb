"""Model configuration (copy of tpuflow/config.py's ModelConfig).

A frozen dataclass with the VideoFlow defaults: T=5 windows, 4 correlation
levels, radius 4, 12 refinement iterations, Twins-SVT encoders.
"""

from __future__ import annotations

from dataclasses import dataclass

# Fast-mode model overrides (the reference's videoflow_core.py:91-94).
FAST_DECODER_DEPTH = 6
FAST_CORR_LEVELS = 3
FAST_CORR_RADIUS = 3

DEFAULT_DECODER_DEPTH = 12
DEFAULT_CORR_LEVELS = 4
DEFAULT_CORR_RADIUS = 4

# Tile size of tile mode (videoflow_processor.py:73-110).
TILE_SIZE = 1280


@dataclass(frozen=True)
class ModelConfig:
    """Model-architecture configuration."""

    model: str = "videoflow"           # 'videoflow' | 'memflow'
    architecture: str = "mof"          # 'mof' | 'bof' (videoflow only)
    dataset: str = "sintel"            # 'sintel' | 'things' | 'kitti'
    variant: str = "standard"          # 'standard' | 'noise'
    stage: str = "sintel"              # memflow training stage
    fast_mode: bool = False
    sequence_length: int = 5

    # Feature/context encoder backbone: 'twins' (Twins-SVT, the upstream
    # checkpoint architecture) or 'cnn' (RAFT BasicEncoder).
    encoder: str = "twins"

    decoder_depth: int = DEFAULT_DECODER_DEPTH
    corr_levels: int = DEFAULT_CORR_LEVELS
    corr_radius: int = DEFAULT_CORR_RADIUS
    feature_dim: int = 256
    context_dim: int = 128
    hidden_dim: int = 128
    memory_capacity: int = 8
    use_rope: bool = False

    # Correlation implementation (core/corr.py make_corr): 'auto' |
    # 'materialized' | 'dense' | 'gather' | 'direct' | 'flash' | 'flash2' |
    # 'band'.
    corr_impl: str = "auto"

    def __post_init__(self):
        if self.fast_mode:
            object.__setattr__(self, "decoder_depth", FAST_DECODER_DEPTH)
            object.__setattr__(self, "corr_levels", FAST_CORR_LEVELS)
            object.__setattr__(self, "corr_radius", FAST_CORR_RADIUS)

    @property
    def checkpoint_filename(self) -> str:
        """Checkpoint naming contract (videoflow_core.py:79-85)."""
        if self.model == "videoflow":
            arch = self.architecture.upper()
            if self.variant == "noise" and self.dataset == "things":
                return f"{arch}_{self.dataset}_288960noise.pth"
            return f"{arch}_{self.dataset}.pth"
        return f"MemFlowNet_{self.stage}.pth"

    @property
    def checkpoint_path(self) -> str:
        if self.model == "videoflow":
            return f"VideoFlow_ckpt/{self.checkpoint_filename}"
        return f"MemFlow_ckpt/{self.checkpoint_filename}"
