"""Output / cache filename contracts.

These strings are a compatibility API: a user switching from the reference
must find their existing caches and get identically-named outputs.
Behavior mirrors the reference's storage/filename_generator.py:13-213
(held to the JAX package's strings by tests/test_torch_port_pipeline.py).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def generate_output_filename(
    input_path: str,
    start_time: Optional[float] = None,
    duration: Optional[float] = None,
    start_frame: int = 0,
    max_frames: int = 1000,
    flow_only: bool = False,
    taa: bool = False,
    fast_mode: bool = False,
    tile_mode: bool = False,
    uncompressed: bool = False,
    flow_format: str = "gamedev",
    motion_vectors_clamp_range: float = 32.0,
    fps: float = 30.0,
) -> str:
    """Build `{base}_{range}_{modes}_{fps}fps_{codec}.avi`
    (reference: filename_generator.py:13-100)."""
    base_name = os.path.splitext(os.path.basename(input_path))[0]
    parts = [base_name]

    if start_time is not None:
        parts.append(f"{start_time}s")
    elif start_frame > 0:
        parts.append(f"f{start_frame}")

    if duration is not None:
        parts.append(f"{duration}s")
    elif max_frames != 1000:
        parts.append(f"{max_frames}f")

    if fast_mode:
        parts.append("fast")
    if tile_mode:
        parts.append("tile")

    if flow_only:
        if flow_format != "gamedev":
            clean_format = (
                flow_format.replace("-", "_").replace("_flow", "").replace("flow_", "")
            )
            if flow_format.startswith("motion-vectors"):
                parts.append(f"{clean_format}_{int(motion_vectors_clamp_range)}")
            else:
                parts.append(clean_format)
        else:
            parts.append("gamedev")
    elif taa:
        parts.append("taa")

    parts.append(f"{fps:.0f}fps")
    parts.append("uncompressed_I420" if uncompressed else "MJPG")
    return "_".join(parts) + ".avi"


def generate_output_filepath(
    input_path: str,
    output_dir: str,
    **kwargs,
) -> str:
    """Directory + filename (reference: filename_generator.py:103-148)."""
    filename = generate_output_filename(input_path=input_path, **kwargs)
    if not os.path.exists(output_dir):
        os.makedirs(output_dir)
    return os.path.join(output_dir, filename)


def generate_cache_directory(
    input_path: str,
    start_frame: int = 0,
    max_frames: int = 1000,
    sequence_length: int = 5,
    fast_mode: bool = False,
    tile_mode: bool = False,
    model: str = "videoflow",
    dataset: str = "things",
    architecture: str = "mof",
    variant: str = "noise",
) -> str:
    """Cache dir name:
    `{video}_flow_cache_{model_params}_{seqL}_{startS}_{framesN}[_fast][_tile]`
    placed next to the input video (reference: filename_generator.py:151-213).
    Cache-affecting flags only — flow-format/taa/etc. are cosmetic and
    deliberately absent (README.md:119-135 of the reference)."""
    video_name = Path(input_path).stem

    model_params = [model]
    if model == "videoflow":
        model_params.append(architecture)
        model_params.append(dataset)
        model_params.append(variant)
    elif model == "memflow":
        model_params.append(dataset)

    cache_params = [f"seq{sequence_length}", f"start{start_frame}", f"frames{max_frames}"]
    if fast_mode:
        cache_params.append("fast")
    if tile_mode:
        cache_params.append("tile")

    model_id = "_".join(model_params)
    cache_id = "_".join(cache_params)
    cache_dir_name = f"{video_name}_flow_cache_{model_id}_{cache_id}"
    return str(Path(input_path).parent / cache_dir_name)
