"""Configuration (copy of tpuflow/config.py: ModelConfig, the MemFlow stage
table and PipelineConfig).

ModelConfig is a frozen dataclass with the VideoFlow defaults: T=5 windows,
4 correlation levels, radius 4, 12 refinement iterations, Twins-SVT
encoders.  PipelineConfig carries the CLI's flags.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Fast-mode model overrides (the reference's videoflow_core.py:91-94).
FAST_DECODER_DEPTH = 6
FAST_CORR_LEVELS = 3
FAST_CORR_RADIUS = 3

DEFAULT_DECODER_DEPTH = 12
DEFAULT_CORR_LEVELS = 4
DEFAULT_CORR_RADIUS = 4

# Tile size of tile mode (videoflow_processor.py:73-110).
TILE_SIZE = 1280

# Per-stage MemFlow model cfg (configs/{stage}_memflownet.py upstream): the
# inference path gates rotary position encoding of the memory readout on
# cfg.rope, which every released stage enables.
MEMFLOW_STAGE_CFG = {
    "sintel": {"use_rope": True},
    "things": {"use_rope": True},
    "kitti": {"use_rope": True},
}


def memflow_stage_cfg(stage: str) -> dict:
    if stage not in MEMFLOW_STAGE_CFG:
        raise ValueError(
            f"Unknown MemFlow stage {stage!r} (expected one of "
            f"{sorted(MEMFLOW_STAGE_CFG)})"
        )
    return MEMFLOW_STAGE_CFG[stage]


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


@dataclass(frozen=True)
class PipelineConfig:
    """Full pipeline configuration (copy of tpuflow/config.py's
    PipelineConfig): the CLI's namespace, with the model's part built by
    `model_config()`.  `device`: 'auto' or 'cuda' (the card), 'cpu'; 'tpu'
    is refused (runtime/device.py DeviceManager)."""

    input: str = ""
    output: str = "results"
    device: str = "auto"               # 'auto' | 'cuda' | 'cpu'
    frames: int = 1000
    start_frame: int = 0
    start_time: Optional[float] = None
    duration: Optional[float] = None
    fast: bool = False
    flow_only: bool = False
    taa: bool = False
    flow_input: Optional[str] = None
    flow_format: str = "gamedev"
    motion_vectors_clamp_range: float = 32.0
    tile: bool = False
    sequence_length: int = 5
    save_flow: Optional[str] = None    # 'flo' | 'npz' | 'both'
    force_recompute: bool = False
    use_flow_cache: Optional[str] = None
    interactive: bool = False
    show_tiles: bool = False
    no_autoplay: bool = True
    skip_lods: bool = False
    uncompressed: bool = False
    model: str = "videoflow"
    model_path: Optional[str] = None
    stage: str = "sintel"
    vf_dataset: str = "sintel"
    vf_architecture: str = "mof"
    vf_variant: str = "standard"
    # Extensions of the reference CLI, as in the JAX package.
    encoder: str = "twins"             # 'twins' (upstream weights) | 'cnn'
    allow_random_init: bool = False    # run without a checkpoint (meaningless flows)
    batch_frames: int = 1              # windows batched per device step
    tile_overlap: int = 0              # halo blend of tiles (0 = reference hard paste)
    data_parallel: int = 1             # devices to shard frames over
    stride_mode: str = "center"        # 'center' (one middle flow per window) |
                                       # 'interior' (every interior flow kept)

    def model_config(self) -> ModelConfig:
        kw = {}
        if self.model == "memflow":
            kw.update(memflow_stage_cfg(self.stage))
        return ModelConfig(
            model=self.model,
            architecture=self.vf_architecture,
            dataset=self.vf_dataset,
            variant=self.vf_variant,
            stage=self.stage,
            encoder=self.encoder,
            fast_mode=self.fast,
            sequence_length=max(2, self.sequence_length)
            if self.model == "memflow"
            else self.sequence_length,
            **kw,
        )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
