"""Frame composition: labeled side-by-side / grid layouts (host-side, cv2).

A copy of the JAX package's pipeline/compose.py.  Behavioral parity with
the reference's visualization/video_composer.py:
outlined text with corner anchors (:17-65), side-by-side / vertical stack /
2x2 TAA grid (:67-122), generic labeled grid with target aspect and
multi-line labels over a darkened band (:124-224).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import cv2
import numpy as np

_FONT = cv2.FONT_HERSHEY_SIMPLEX


class VideoComposer:
    """Composes output frames for video writing (BGR)."""

    def add_text_overlay(
        self,
        frame: np.ndarray,
        text: str,
        position: Union[str, Tuple[int, int]] = "top-left",
        font_scale: float = 0.4,
        color: Tuple[int, int, int] = (255, 255, 255),
        thickness: int = 1,
    ) -> np.ndarray:
        """White text with a black outline at a corner anchor
        (video_composer.py:17-65)."""
        if frame is None:
            return frame
        out = frame.copy()
        h, w = frame.shape[:2]
        (tw, th), _ = cv2.getTextSize(text, _FONT, font_scale, thickness)
        margin = 5
        anchors = {
            "top-left": (margin, th + margin),
            "top-right": (w - tw - margin, th + margin),
            "bottom-left": (margin, h - margin),
            "bottom-right": (w - tw - margin, h - margin),
        }
        pos = position if isinstance(position, tuple) else anchors.get(position, anchors["top-left"])
        cv2.putText(out, text, pos, _FONT, font_scale, (0, 0, 0), thickness + 1, cv2.LINE_AA)
        cv2.putText(out, text, pos, _FONT, font_scale, color, thickness, cv2.LINE_AA)
        return out

    def create_side_by_side(
        self,
        original: np.ndarray,
        flow_viz: np.ndarray,
        flow_only: bool = False,
        taa_frame: Optional[np.ndarray] = None,
        taa_simple_frame: Optional[np.ndarray] = None,
        model_name: str = "VideoFlow",
        fast_mode: bool = False,
        flow_format: str = "gamedev",
    ) -> np.ndarray:
        """Side-by-side / vertical flow-only stack / 2x2 TAA grid, labeled,
        RGB inputs -> BGR output (video_composer.py:67-122)."""
        h, w = original.shape[:2]
        if flow_viz.shape[:2] != (h, w):
            flow_viz = cv2.resize(flow_viz, (w, h))

        orig_bgr = cv2.cvtColor(original, cv2.COLOR_RGB2BGR)
        flow_bgr = cv2.cvtColor(flow_viz, cv2.COLOR_RGB2BGR)

        if flow_only:
            return np.concatenate([orig_bgr, flow_bgr], axis=0)

        mode_text = " (Fast)" if fast_mode else ""
        orig_bgr = self.add_text_overlay(orig_bgr, f"Original{mode_text}", "top-left")
        flow_bgr = self.add_text_overlay(flow_bgr, f"Optical Flow{mode_text}", "top-left")
        flow_bgr = self.add_text_overlay(
            flow_bgr, f"{model_name} ({flow_format.upper()})", "bottom-left"
        )

        def _to_bgr(x: np.ndarray) -> np.ndarray:
            return cv2.cvtColor(np.clip(x, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR)

        if taa_frame is not None and taa_simple_frame is not None:
            taa_bgr = self.add_text_overlay(_to_bgr(taa_frame), "TAA + Inv.Flow", "top-left")
            taa_bgr = self.add_text_overlay(taa_bgr, "Alpha: 0.1", "bottom-left")
            taa_simple_bgr = self.add_text_overlay(
                _to_bgr(taa_simple_frame), "TAA Simple", "top-left"
            )
            taa_simple_bgr = self.add_text_overlay(taa_simple_bgr, "Alpha: 0.1", "bottom-left")
            top = np.concatenate([orig_bgr, flow_bgr], axis=1)
            bottom = np.concatenate([taa_bgr, taa_simple_bgr], axis=1)
            return np.concatenate([top, bottom], axis=0)

        if taa_frame is not None:
            taa_bgr = self.add_text_overlay(_to_bgr(taa_frame), "TAA + Inv.Flow", "top-left")
            taa_bgr = self.add_text_overlay(taa_bgr, "Alpha: 0.1", "bottom-left")
            return np.concatenate([orig_bgr, flow_bgr, taa_bgr], axis=1)

        return np.concatenate([orig_bgr, flow_bgr], axis=1)

    def create_video_grid(
        self,
        frames_dict: Dict[str, np.ndarray],
        grid_shape: Tuple[int, int],
        target_aspect: float = 16 / 9,
    ) -> Optional[np.ndarray]:
        """Labeled grid on a black canvas sized to a target aspect ratio,
        multi-line labels on a darkened band (video_composer.py:124-224)."""
        if not frames_dict:
            return None

        rows, cols = grid_shape
        first = next(iter(frames_dict.values()))
        h, w = first.shape[:2]

        canvas_w = cols * w
        canvas_h = int(canvas_w / target_aspect)
        canvas = np.zeros((canvas_h, canvas_w, 3), dtype=np.uint8)
        y_offset = (canvas_h - rows * h) // 2
        x_offset = (canvas_w - cols * w) // 2

        for i, (label, frame) in enumerate(frames_dict.items()):
            if i >= rows * cols:
                break
            row, col = divmod(i, cols)
            y0 = y_offset + row * h
            x0 = x_offset + col * w

            # Convert to BGR; TAA frames may be float.
            if "TAA-" in label:
                frame = np.clip(frame, 0, 255).astype(np.uint8)
            if frame.ndim == 3 and frame.shape[2] == 3:
                frame_bgr = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
            else:
                frame_bgr = frame

            labeled = frame_bgr.copy()
            lines = label.split("\n")
            font_scale, thickness, line_height, start_y = 0.7, 2, 30, 25

            max_tw = max(
                cv2.getTextSize(line, _FONT, font_scale, thickness)[0][0] for line in lines
            )
            band = labeled.copy()
            cv2.rectangle(band, (0, 0), (max_tw + 15, len(lines) * line_height + 10), (0, 0, 0), -1)
            cv2.addWeighted(band, 0.7, labeled, 0.3, 0, labeled)

            for li, line in enumerate(lines):
                y = start_y + li * line_height
                cv2.putText(labeled, line, (8, y), _FONT, font_scale, (0, 0, 0), thickness + 2, cv2.LINE_AA)
                cv2.putText(labeled, line, (8, y), _FONT, font_scale, (255, 255, 255), thickness, cv2.LINE_AA)

            # Guard both ends: a too-narrow target aspect makes the grid
            # taller than the canvas (negative offsets).
            if 0 <= y0 and y0 + h <= canvas_h and 0 <= x0 and x0 + w <= canvas_w:
                canvas[y0 : y0 + h, x0 : x0 + w] = labeled

        return canvas


def add_text_overlay(frame, text, position="top-left", font_scale=0.4,
                     color=(255, 255, 255), thickness=1):
    return VideoComposer().add_text_overlay(frame, text, position, font_scale, color, thickness)


def create_side_by_side(original, flow_viz, flow_only=False, taa_frame=None,
                        taa_simple_frame=None, model_name="VideoFlow",
                        fast_mode=False, flow_format="gamedev"):
    return VideoComposer().create_side_by_side(
        original, flow_viz, flow_only, taa_frame, taa_simple_frame,
        model_name, fast_mode, flow_format,
    )


def create_video_grid(frames_dict, grid_shape, target_aspect=16 / 9):
    return VideoComposer().create_video_grid(frames_dict, grid_shape, target_aspect)
