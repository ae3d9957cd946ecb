"""Class-based TAA API (the JAX package's pipeline/taa.py; drop-in parity
with the reference's effects/taa_processor.py).

The math is pipeline/ops.py's taa_step, on the processor's device (the
card unless the caller asks for the CPU); these classes add the
reference's stateful conveniences: per-sequence history dict
(taa_processor.py:39), alpha management (:315-324), and the comparison
processor that runs flow-based and simple TAA side by side (:327-384).
Frames and flows come in as numpy arrays and results go out as numpy
arrays; the histories stay on the device."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime.device import resolve_device
from . import ops


class TAAProcessor:
    """Temporal anti-aliasing with optional flow reprojection
    (taa_processor.py:20-324)."""

    def __init__(self, alpha: float = 0.1, bilateral_sigma_color: float = 25.0, device="cuda"):
        self.alpha = alpha
        self.bilateral_sigma_color = bilateral_sigma_color
        self.device = resolve_device(device)
        self.history: Dict[str, torch.Tensor] = {}

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    def apply_taa(
        self,
        current_frame: np.ndarray,
        flow_pixels: Optional[np.ndarray] = None,
        previous_taa_frame: Optional[np.ndarray] = None,
        alpha: Optional[float] = None,
        use_flow: bool = True,
        use_bilateral: bool = True,
        sequence_id: str = "default",
    ) -> np.ndarray:
        alpha = self.alpha if alpha is None else alpha
        previous = (
            self.history.get(sequence_id)
            if previous_taa_frame is None
            else self._upload(previous_taa_frame)
        )
        current = self._upload(current_frame)

        if previous is None:
            # First frame: history seeds with the frame itself
            # (taa_processor.py:70-74).
            result = current
        else:
            use = use_flow and flow_pixels is not None
            result = ops.taa_step(
                current,
                self._upload(flow_pixels) if use else None,
                previous,
                alpha=alpha,
                use_flow=use,
                use_bilateral=use_bilateral,
                sigma_color=self.bilateral_sigma_color,
            )
        self.history[sequence_id] = result
        return result.cpu().numpy()

    def apply_simple_taa(
        self,
        current_frame: np.ndarray,
        previous_taa_frame: Optional[np.ndarray] = None,
        alpha: Optional[float] = None,
        sequence_id: str = "simple",
    ) -> np.ndarray:
        return self.apply_taa(
            current_frame,
            flow_pixels=None,
            previous_taa_frame=previous_taa_frame,
            alpha=alpha,
            use_flow=False,
            use_bilateral=False,
            sequence_id=sequence_id,
        )

    def reset_history(self, sequence_id: Optional[str] = None) -> None:
        if sequence_id is None:
            self.history.clear()
        else:
            self.history.pop(sequence_id, None)

    def get_history(self, sequence_id: str = "default") -> Optional[np.ndarray]:
        hist = self.history.get(sequence_id)
        return None if hist is None else hist.cpu().numpy()

    def set_alpha(self, alpha: float) -> None:
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("Alpha must be between 0.0 and 1.0")
        self.alpha = alpha


class TAAComparisonProcessor:
    """Run flow-based and simple TAA in lockstep (taa_processor.py:327-384)."""

    def __init__(self, alpha: float = 0.1, device="cuda"):
        self.flow_taa = TAAProcessor(alpha, device=device)
        self.simple_taa = TAAProcessor(alpha, device=device)

    def apply_comparison(
        self,
        current_frame: np.ndarray,
        flow_pixels: Optional[np.ndarray] = None,
        alpha: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        flow_result = self.flow_taa.apply_taa(
            current_frame, flow_pixels=flow_pixels, alpha=alpha,
            use_flow=True, use_bilateral=True, sequence_id="flow",
        )
        simple_result = self.simple_taa.apply_simple_taa(
            current_frame, alpha=alpha, sequence_id="simple"
        )
        return flow_result, simple_result

    def reset_history(self) -> None:
        self.flow_taa.reset_history()
        self.simple_taa.reset_history()

    def set_alpha(self, alpha: float) -> None:
        self.flow_taa.set_alpha(alpha)
        self.simple_taa.set_alpha(alpha)


def apply_taa_effect(
    current_frame: np.ndarray,
    flow_pixels: Optional[np.ndarray] = None,
    previous_taa_frame: Optional[np.ndarray] = None,
    alpha: float = 0.1,
    use_flow: bool = True,
    device="cuda",
) -> np.ndarray:
    """Stateless convenience (taa_processor.py:387-412)."""
    return TAAProcessor(alpha, device=device).apply_taa(
        current_frame,
        flow_pixels=flow_pixels,
        previous_taa_frame=previous_taa_frame,
        alpha=alpha,
        use_flow=use_flow,
    )
