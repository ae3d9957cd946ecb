"""Host-side video IO: metadata probing, frame extraction, writing.

A copy of the JAX package's pipeline/video_io.py: decode and encode stay on
the host (OpenCV), feeding device batches.  Behavior contracts preserved
from the reference:

- metadata probe + time<->frame conversion: video/video_info.py:26-133
- fast-mode resolution policy: video/frame_extractor.py:26-62
  (target <=256px; floor scale at 0.25x for >512px sources and 0.5x for
  >256px sources; even dims; minimum 64px)
- extraction: seek, BGR->RGB, optional resize: frame_extractor.py:64-142

The JAX package's addition is `FrameStream`, a decode-ahead iterator that
keeps the host decoder off the device critical path.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover - cv2 is in the image
    _HAS_CV2 = False


class VideoInfo:
    """Video metadata with a memo cache (video_info.py:10-148)."""

    def __init__(self, video_path: str):
        self.video_path = Path(video_path)
        self._info_cache: Optional[Dict] = None
        if not self.video_path.exists():
            raise FileNotFoundError(f"Video file not found: {video_path}")

    def get_info(self) -> Dict:
        if self._info_cache is not None:
            return self._info_cache
        cap = cv2.VideoCapture(str(self.video_path))
        if not cap.isOpened():
            raise ValueError(f"Cannot open video: {self.video_path}")
        try:
            fps = cap.get(cv2.CAP_PROP_FPS)
            info = {
                "fps": fps,
                "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                "total_frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                "duration_seconds": None,
                "path": str(self.video_path),
            }
            if fps > 0:
                info["duration_seconds"] = info["total_frames"] / fps
            self._info_cache = info
            return info
        finally:
            cap.release()

    def get_fps(self) -> float:
        return self.get_info()["fps"]

    def get_dimensions(self) -> Tuple[int, int]:
        info = self.get_info()
        return info["width"], info["height"]

    def get_frame_count(self) -> int:
        return self.get_info()["total_frames"]

    def get_duration(self) -> float:
        duration = self.get_info()["duration_seconds"]
        if duration is None:
            raise ValueError("Cannot calculate duration: invalid FPS")
        return duration

    def time_to_frame(self, time_seconds: float) -> int:
        fps = self.get_fps()
        if fps <= 0:
            raise ValueError("Cannot convert time to frame: invalid FPS")
        return int(time_seconds * fps)

    def frame_to_time(self, frame_number: int) -> float:
        fps = self.get_fps()
        if fps <= 0:
            raise ValueError("Cannot convert frame to time: invalid FPS")
        return frame_number / fps

    def validate_frame_range(self, start_frame: int, frame_count: int) -> Tuple[int, int]:
        """Clamp a (start, count) request to the video length
        (video_info.py:110-133)."""
        total = self.get_frame_count()
        if start_frame < 0:
            start_frame = 0
        elif start_frame >= total:
            raise ValueError(f"Start frame {start_frame} exceeds total frames {total}")
        return start_frame, min(frame_count, total - start_frame)

    def reset_cache(self) -> None:
        self._info_cache = None


def fast_mode_dimensions(
    orig_width: int, orig_height: int, fast_mode: bool = True
) -> Tuple[int, int, float]:
    """The fast-mode resolution policy (frame_extractor.py:26-62):
    target <=256px on the long edge, scale floored at 0.25x for sources
    over 512px and 0.5x over 256px; dims forced even with a 64px floor."""
    if not fast_mode:
        return orig_width, orig_height, 1.0

    max_dimension = 256
    scale = min(max_dimension / orig_width, max_dimension / orig_height)
    if scale > 1.0:
        scale = 1.0
    longest = max(orig_width, orig_height)
    if longest > 512:
        scale = min(scale, 0.25)
    elif longest > 256:
        scale = min(scale, 0.5)

    width = int(orig_width * scale)
    height = int(orig_height * scale)
    width = max(64, width - (width % 2))
    height = max(64, height - (height % 2))
    return width, height, scale


class FrameExtractor:
    """Frame extraction with fast-mode resizing (frame_extractor.py:12-142)."""

    def __init__(self, video_path: str, fast_mode: bool = False):
        self.video_info = VideoInfo(video_path)
        self.fast_mode = fast_mode

    def calculate_fast_mode_dimensions(
        self, orig_width: int, orig_height: int
    ) -> Tuple[int, int, float]:
        return fast_mode_dimensions(orig_width, orig_height, self.fast_mode)

    def extract_frames(
        self,
        max_frames: int = 1000,
        start_frame: int = 0,
        start_time: Optional[float] = None,
        duration: Optional[float] = None,
        progress: bool = True,
    ) -> Tuple[List[np.ndarray], float, int, int, int]:
        """Extract RGB frames into host RAM.

        Returns (frames, fps, width, height, actual_start_frame), matching
        the reference's tuple (frame_extractor.py:64-142)."""
        info = self.video_info.get_info()
        fps = info["fps"]

        if start_time is not None:
            start_frame = self.video_info.time_to_frame(start_time)
            print(f"Start time: {start_time}s -> frame {start_frame}")
        if duration is not None:
            max_frames = self.video_info.time_to_frame(duration)
            print(f"Duration: {duration}s -> {max_frames} frames")

        start_frame, n_frames = self.video_info.validate_frame_range(start_frame, max_frames)
        width, height, scale = self.calculate_fast_mode_dimensions(
            info["width"], info["height"]
        )
        if self.fast_mode:
            print(
                f"Fast mode: aggressive resolution reduction from "
                f"{info['width']}x{info['height']} to {width}x{height} "
                f"(scale: {scale:.2f})"
            )

        frames: List[np.ndarray] = []
        cap = cv2.VideoCapture(str(self.video_info.video_path))
        if not cap.isOpened():
            raise ValueError(f"Cannot open video: {self.video_info.video_path}")
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
            iterator = range(n_frames)
            if progress:
                try:
                    from tqdm import tqdm

                    iterator = tqdm(iterator, desc="Extracting frames")
                except ImportError:
                    pass
            for i in iterator:
                ok, frame = cap.read()
                if not ok:
                    print(f"Warning: Could only extract {len(frames)} frames out of {n_frames}")
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if self.fast_mode and scale != 1.0:
                    rgb = cv2.resize(rgb, (width, height))
                frames.append(rgb)
        finally:
            cap.release()

        print(f"Frame range: {start_frame} to {start_frame + len(frames) - 1}")
        return frames, fps, width, height, start_frame

    def get_frame_at_time(self, time_seconds: float) -> np.ndarray:
        """Single-frame fetch (frame_extractor.py:159-194)."""
        frame_number = self.video_info.time_to_frame(time_seconds)
        cap = cv2.VideoCapture(str(self.video_info.video_path))
        if not cap.isOpened():
            raise ValueError(f"Cannot open video: {self.video_info.video_path}")
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, frame_number)
            ok, frame = cap.read()
            if not ok:
                raise ValueError(
                    f"Cannot read frame at time {time_seconds}s (frame {frame_number})"
                )
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if self.fast_mode:
                info = self.video_info.get_info()
                w, h, _ = self.calculate_fast_mode_dimensions(info["width"], info["height"])
                rgb = cv2.resize(rgb, (w, h))
            return rgb
        finally:
            cap.release()


class FrameStream:
    """Decode-ahead frame iterator (an addition to the reference).

    A background thread decodes + resizes frames into a bounded queue so
    host decoding overlaps device compute.  The reference loads all frames
    into RAM up front (frame_extractor.py:116-132); this streams with a
    bounded footprint for long videos while still allowing full prefetch
    for short clips.
    """

    def __init__(
        self,
        video_path: str,
        fast_mode: bool = False,
        start_frame: int = 0,
        max_frames: int = 1000,
        prefetch: int = 64,
    ):
        self.extractor = FrameExtractor(video_path, fast_mode)
        info = self.extractor.video_info.get_info()
        self.start_frame, self.n_frames = self.extractor.video_info.validate_frame_range(
            start_frame, max_frames
        )
        self.width, self.height, self.scale = self.extractor.calculate_fast_mode_dimensions(
            info["width"], info["height"]
        )
        self.fps = info["fps"]
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _decode_loop(self) -> None:
        cap = cv2.VideoCapture(str(self.extractor.video_info.video_path))
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
            for _ in range(self.n_frames):
                if self._stop.is_set():
                    break
                ok, frame = cap.read()
                if not ok:
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if self.extractor.fast_mode and self.scale != 1.0:
                    rgb = cv2.resize(rgb, (self.width, self.height))
                self._queue.put(rgb)
        finally:
            cap.release()
            self._queue.put(None)

    def __iter__(self) -> Iterator[np.ndarray]:
        self._thread = threading.Thread(target=self._decode_loop, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is None:
                return
            yield item

    def close(self) -> None:
        self._stop.set()


class VideoWriter:
    """Thin MJPG / raw-I420 writer wrapper (flow_processor.py:895-917)."""

    def __init__(
        self, path: str, fps: float, size: Tuple[int, int], uncompressed: bool = False
    ):
        fourcc = (
            cv2.VideoWriter_fourcc(*"I420")
            if uncompressed
            else cv2.VideoWriter_fourcc(*"MJPG")
        )
        self.writer = cv2.VideoWriter(path, fourcc, fps, size)
        if not self.writer.isOpened():
            raise ValueError(f"Cannot open video writer for: {path}")
        self.path = path

    def write_bgr(self, frame_bgr: np.ndarray) -> None:
        self.writer.write(frame_bgr)

    def write_rgb(self, frame_rgb: np.ndarray) -> None:
        self.writer.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        self.writer.release()

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
