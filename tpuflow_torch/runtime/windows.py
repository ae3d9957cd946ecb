"""Frame-window index math (copy of tpuflow/runtime/windows.py)."""

from __future__ import annotations

import numpy as np


def centered_window_indices(num_frames: int, frame_idx: int, length: int) -> np.ndarray:
    """Centered window with edge replication, mirroring
    videoflow_processor.py:122-147.  Returns int array [length]."""
    half = length // 2
    start = max(0, frame_idx - half)
    end = min(num_frames, frame_idx + half + 1)
    seq = list(range(start, end))
    while len(seq) < length:
        if start == 0:
            seq.insert(0, seq[0])
        else:
            seq.append(seq[-1])
    return np.asarray(seq[:length], dtype=np.int32)


def trailing_window_indices(num_frames: int, frame_idx: int, length: int) -> np.ndarray:
    """Trailing window [idx+1-L, idx], front-padded with the first frame
    (memflow_processor.py:97-139); L is at least 2."""
    length = max(2, length)
    start = frame_idx + 1 - length
    seq = [max(0, i) for i in range(start, frame_idx + 1)]
    return np.asarray(seq, dtype=np.int32)


def all_window_indices(num_frames: int, length: int, kind: str = "centered") -> np.ndarray:
    """Index matrix [num_frames, length] of every frame's window ('centered'
    or else trailing)."""
    fn = centered_window_indices if kind == "centered" else trailing_window_indices
    return np.stack([fn(num_frames, i, length) for i in range(num_frames)])
