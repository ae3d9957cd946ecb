"""Interactive flow visualizer/debugger (the JAX package's
tools/visualizer.py on the port's ops and correction engine).

The reference's flow_visualizer.py (3183 LoC Tk app) splits here into:

- `FlowInspector` — the headless data/analysis core: loads frames, flows,
  LOD pyramids (flow_visualizer.py:146-196, 335-380), computes quality
  maps and turbulence maps via the batched device ops (instead of
  background threads + queue polling, flow_visualizer.py:601-658), runs
  single-pixel coarse/fine correction analysis (:768-968) and batch range
  correction (:2598-2865) through tpuflow_torch.tools.correction, on its
  `device` (the card by default; 'cpu' on request).
- `FlowVisualizerApp` — a thin Tk shell: 3-panel canvas (frame N /
  frame N+1 / quality-or-turbulence map), zoom 0.1-5x, pan, frame slider,
  hover flow arrow with quality readout, click-to-analyze, correction
  controls, and a "Run TAA with corrected flow" button that re-invokes the
  CLI (flow_visualizer.py:2873-2962).

The core is fully testable without a display; the Tk layer degrades to a
clear error message when no display is available.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..pipeline import ops
from ..pipeline.cache import FlowCacheManager, FlowFileHandler
from ..pipeline.video_io import FrameExtractor
from ..runtime.device import DeviceManager
from . import correction as corr_mod

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class FlowInspector:
    """Headless visualizer core: data loading + analysis.  Frames and flows
    stay on the host; each analysis uploads what it reads to `device`
    ('auto' = the card, 'cuda[:N]' or 'cpu', or a torch.device)."""

    def __init__(
        self,
        video_path: str,
        flow_dir: str,
        fast_mode: bool = False,
        max_frames: Optional[int] = None,
        start_frame: int = 0,
        preload: bool = True,
        device="auto",
    ):
        self.device = DeviceManager.get_device(device) if isinstance(device, str) else device
        self.video_path = video_path
        self.flow_dir = flow_dir
        self.cache_manager = FlowCacheManager()

        self.flow_files = self.find_flow_files(flow_dir)
        n = len(self.flow_files) if max_frames is None else min(max_frames, len(self.flow_files))
        self.flow_files = self.flow_files[:n]

        extractor = FrameExtractor(video_path, fast_mode=fast_mode)
        frames, self.fps, self.width, self.height, _ = extractor.extract_frames(
            max_frames=n + 1, start_frame=start_frame, progress=False
        )
        # The reference duplicates the last frame so frame N+1 always
        # exists (flow_visualizer.py:335-361).
        if len(frames) <= n:
            frames.append(frames[-1].copy())
        self.frames = frames

        self.flow_cache: Dict[int, np.ndarray] = {}
        self.lod_cache: Dict[Tuple[int, int], np.ndarray] = {}
        if preload:
            self._preload_all()

    def _up(self, x) -> torch.Tensor:
        """A copy of a host array on the inspector's device (float64 as float32;
        cached flows are read-only)."""
        return ops._tensor(np.array(x)).to(self.device)

    # -- file discovery (flow_visualizer.py:363-380) ------------------------
    @staticmethod
    def find_flow_files(flow_dir: str) -> List[str]:
        """All per-frame .flo/.npz flows, excluding `_lod` derivatives,
        sorted by frame index."""
        p = Path(flow_dir)
        if not p.is_dir():
            raise FileNotFoundError(f"Flow directory not found: {flow_dir}")
        files = [
            f
            for f in p.iterdir()
            if f.suffix in (".flo", ".npz") and "_lod" not in f.stem
        ]

        def frame_idx(f: Path) -> int:
            m = re.search(r"(\d+)", f.stem)
            return int(m.group(1)) if m else 0

        # Prefer npz when both exist for a frame.
        by_idx: Dict[int, Path] = {}
        for f in sorted(files, key=lambda f: (frame_idx(f), f.suffix != ".npz")):
            by_idx.setdefault(frame_idx(f), f)
        return [str(by_idx[i]) for i in sorted(by_idx)]

    def _preload_all(self) -> None:
        """Preload flows + LODs into RAM (flow_visualizer.py:146-196),
        generating missing LODs on the fly (:270-290)."""
        for i, f in enumerate(self.flow_files):
            self.flow_cache[i] = self.load_flow(i)
        for i in range(len(self.flow_files)):
            for lod in range(5):
                try:
                    self.lod_cache[(i, lod)] = self.cache_manager.load_flow_lod(
                        self.flow_dir, i, lod
                    )
                except FileNotFoundError:
                    lods = self.cache_manager.lod_generator.generate_lods(
                        self.flow_cache[i], 5
                    )
                    self.cache_manager.save_flow_lods(lods, self.flow_dir, i)
                    for k, l in enumerate(lods):
                        self.lod_cache[(i, k)] = l
                    break

    def load_flow(self, idx: int) -> np.ndarray:
        if idx in self.flow_cache:
            return self.flow_cache[idx]
        path = Path(self.flow_files[idx])
        if path.suffix == ".flo":
            return FlowFileHandler.load_flow_flo(str(path))
        return FlowFileHandler.load_flow_npz(str(path))["flow"]

    # -- analysis ------------------------------------------------------------
    def quality_map(self, idx: int, threshold: float = corr_mod.GOOD_QUALITY_THRESHOLD) -> np.ndarray:
        """Red/green quality frame for frame idx -> idx+1."""
        return ops.quality_frame(
            self._up(self.frames[idx]), self._up(self.frames[idx + 1]), self._up(self.load_flow(idx)), threshold
        ).cpu().numpy()

    def turbulence_map(self, idx: int) -> np.ndarray:
        """Percentile-normalized JET-colored local flow variance
        (flow_visualizer.py:2997-3052)."""
        var = ops.turbulence_map(self._up(self.load_flow(idx))).cpu().numpy()
        hi = np.percentile(var, 99.0)
        norm = np.clip(var / max(hi, 1e-9), 0, 1)
        u8 = (norm * 255).astype(np.uint8)
        if cv2 is not None:
            jet = cv2.applyColorMap(u8, cv2.COLORMAP_JET)
            return cv2.cvtColor(jet, cv2.COLOR_BGR2RGB)
        return np.stack([u8, u8, u8], axis=-1)

    def sample_flow(self, idx: int, x: int, y: int) -> Tuple[float, float]:
        """Flow vector at a pixel, scaled frame->flow resolution if needed."""
        flow = self.load_flow(idx)
        fh, fw = flow.shape[:2]
        fx = int(x * fw / self.width)
        fy = int(y * fh / self.height)
        fx = min(max(fx, 0), fw - 1)
        fy = min(max(fy, 0), fh - 1)
        v = flow[fy, fx]
        return float(v[0] * self.width / fw), float(v[1] * self.height / fh)

    def pixel_quality(self, idx: int, x: int, y: int) -> float:
        """Quality of the flow vector at one pixel (hover readout)."""
        fx, fy = self.sample_flow(idx, x, y)
        tx = int(round(x - fx))
        ty = int(round(y - fy))
        if not (0 <= tx < self.width and 0 <= ty < self.height):
            return 0.0
        return float(
            ops.pixel_quality(
                self._up(self.frames[idx][y, x]).float(),
                self._up(self.frames[idx + 1][ty, tx]).float(),
            )
        )

    def _lod_vector(self, idx: int, x: int, y: int) -> np.ndarray:
        """The LOD-4 flow at (x, y) in frame pixels (the flow itself where
        no LOD is loaded)."""
        lod = self.lod_cache.get((idx, 4))
        if lod is None:
            lod = self.load_flow(idx)
        lh, lw = lod.shape[:2]
        lx = min(int(x * lw / self.width), lw - 1)
        ly = min(int(y * lh / self.height), lh - 1)
        return lod[ly, lx] / np.array([lw / self.width, lh / self.height])

    def analyze_pixel(self, idx: int, x: int, y: int) -> Dict:
        """Single-pixel coarse(+fine) correction analysis
        (flow_visualizer.py:768-968) via the batched passes with N=1."""
        f1 = self._up(self.frames[idx])
        f2 = self._up(self.frames[idx + 1])
        lod_vec = self._lod_vector(idx, x, y)

        coarse = corr_mod.coarse_correction_batch(
            f1, f2, self._up(np.asarray([[x, y]], np.int32)), self._up(np.asarray([lod_vec], np.float32))
        )
        coarse = {k: v.cpu().numpy()[0] for k, v in coarse.items()}
        result = {"coarse": coarse, "fine": None}
        if coarse["similarity"] < corr_mod.FINE_CORRECTION_THRESHOLD:
            fine = corr_mod.fine_correction_batch(
                f1, f2, self._up(np.asarray([[x, y]], np.int32)), self._up(np.asarray([coarse["target"]], np.float32))
            )
            result["fine"] = {k: v.cpu().numpy()[0] for k, v in fine.items()}
        return result

    def correct_range(self, start: int, end: int, progress: bool = True) -> List[Dict]:
        """Batch correction over [start, end) -> `<cache>_corrected/`
        (flow_visualizer.py:2725-2865, minus the thread pool: each frame is
        one batched device pass)."""
        results = corr_mod.correct_cache_range(
            self.frames,
            self.flow_files,
            list(range(start, min(end, len(self.flow_files)))),
            lod_loader=lambda i: self.lod_cache.get((i, 4)),
            progress=progress,
            device=self.device,
        )
        # Post-hoc verification (flow_visualizer.py:2808-2825).
        missing = [r["path"] for r in results if not os.path.exists(r["path"])]
        if missing:
            print(f"Warning: {len(missing)} corrected flow files missing after batch")
        return results

    def detail_analysis(self, idx: int, x: int, y: int, patch: int = 32) -> Dict:
        """Detail-analysis view data (flow_visualizer.py:2101-2349): the
        source patch around (x, y), the flow-displaced target patch, the
        corrected-candidate target patch, and their similarities —
        everything the overlay renders, display-independent."""
        res = self.analyze_pixel(idx, x, y)
        f1, f2 = self.frames[idx], self.frames[idx + 1]
        fx, fy = self.sample_flow(idx, x, y)

        def crop(img, cx, cy):
            h, w = img.shape[:2]
            half = patch // 2
            x0, y0 = int(round(cx)) - half, int(round(cy)) - half
            sx0, sy0 = max(0, x0), max(0, y0)
            sx1, sy1 = min(w, x0 + patch), min(h, y0 + patch)
            out = np.zeros((patch, patch, 3), img.dtype)
            out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[sy0:sy1, sx0:sx1]
            return out

        coarse = res["coarse"]
        best = res["fine"] if res["fine"] is not None else coarse
        return {
            "pixel": (x, y),
            "flow": (fx, fy),
            "source_patch": crop(f1, x, y),
            # Flow maps frame idx -> idx+1; the TAA/correction convention
            # samples the PREVIOUS frame at p - flow, so the current flow
            # target in frame idx+1 of pixel p is p - flow (ops.py TAA).
            "target_patch": crop(f2, x - fx, y - fy),
            "corrected_patch": crop(f2, best["target"][0], best["target"][1]),
            "current_similarity": float(self.pixel_quality(idx, x, y)),
            "coarse": coarse,
            "fine": res["fine"],
            "corrected_flow": tuple(np.asarray(best["flow"], np.float64)),
            "corrected_similarity": float(best["similarity"]),
        }

    def consistency_check(self, idx: int, x: int, y: int) -> Dict:
        """Single-pixel vs batch 'logic inconsistency' check
        (flow_visualizer.py:940-959): the single-pixel analysis and the
        batched correction pass must propose the same target for the
        same input; a mismatch indicates a bug."""
        single = self.analyze_pixel(idx, x, y)["coarse"]
        lod_vec = self._lod_vector(idx, x, y)
        batch = corr_mod.coarse_correction_batch(
            self._up(self.frames[idx]), self._up(self.frames[idx + 1]),
            self._up(np.asarray([[x, y], [x, y]], np.int32)),  # batched (N=2, duplicated)
            self._up(np.asarray([lod_vec, lod_vec], np.float32)),
        )
        batch = {k: v.cpu().numpy()[0] for k, v in batch.items()}
        dt = np.abs(np.asarray(single["target"]) - np.asarray(batch["target"]))
        ds = abs(float(single["similarity"]) - float(batch["similarity"]))
        consistent = bool((dt <= 1e-3).all() and ds <= 1e-3)
        return {
            "consistent": consistent,
            "single": single,
            "batch": batch,
            "target_delta": dt,
            "similarity_delta": ds,
        }

    # -- deferred quality maps (flow_visualizer.py:601-658) ------------------
    def quality_map_cached(self, idx: int):
        """Return the cached quality map, or None and schedule a
        background compute (the reference's worker-thread + queue-poll
        design, minus the polling: `on_ready` fires from the worker)."""
        if not hasattr(self, "_qmap_cache"):
            self._qmap_cache: Dict[int, np.ndarray] = {}
        return self._qmap_cache.get(idx)

    def compute_quality_async(self, idx: int, on_ready=None):
        """Compute quality_map(idx) in a daemon thread, cache it, then
        call `on_ready(idx, map)` (from the worker thread — Tk callers
        must re-enter the main loop, see FlowVisualizerApp._on_quality)."""
        import threading

        if not hasattr(self, "_qmap_cache"):
            self._qmap_cache = {}
        if idx in self._qmap_cache:
            if on_ready:
                on_ready(idx, self._qmap_cache[idx])
            return None

        def work():
            qm = self.quality_map(idx)
            self._qmap_cache[idx] = qm
            if on_ready:
                on_ready(idx, qm)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        return t

    def cache_statistics(self) -> Dict:
        """LOD cache statistics report (flow_processor.py:229-408 /
        flow_visualizer.py:421-600)."""
        n = len(self.flow_files)
        lod_counts = {k: 0 for k in range(5)}
        total_bytes = 0
        for i in range(n):
            for lod in range(5):
                f = Path(self.flow_dir) / f"flow_frame_{i:06d}_lod{lod}.npz"
                if f.exists():
                    lod_counts[lod] += 1
                    total_bytes += f.stat().st_size
        flow_bytes = sum(Path(f).stat().st_size for f in self.flow_files)
        return {
            "frames": n,
            "flow_files": n,
            "flow_bytes": flow_bytes,
            "lod_counts": lod_counts,
            "lod_bytes": total_bytes,
            "complete_lods": all(c == n for c in lod_counts.values()),
        }


def run_taa_with_flow(video_path: str, flow_dir: str, extra_args: Optional[List[str]] = None) -> subprocess.Popen:
    """Re-invoke the CLI with --use-flow-cache (the visualizer's
    'Run TAA with corrected flow' button, flow_visualizer.py:2873-2962)."""
    cmd = [
        sys.executable, "-m", "tpuflow_torch.tools.cli",
        "--input", video_path,
        "--use-flow-cache", flow_dir,
        "--taa", "--no-autoplay",
    ] + (extra_args or [])
    return subprocess.Popen(cmd)


def launch_interactive(config) -> int:
    """`--interactive` entry (flow_processor.py:1389-1529): ensure a cache
    exists (computing the flows through FlowPipeline if it is incomplete),
    audit its LODs, then run the visualizer in-process on the pipeline's
    device (the reference re-spawns a child python,
    flow_processor.py:1502-1523 — unnecessary here).  Without a display it
    prints the cache statistics and returns 1."""
    from .pipeline import FlowPipeline

    pipeline = FlowPipeline(config)
    extractor = FrameExtractor(config.input, fast_mode=config.fast)
    start, n = extractor.video_info.validate_frame_range(config.start_frame, config.frames)

    flow_dir = config.use_flow_cache or pipeline.cache_dir_for(config.input, start, n)
    ok, _, missing = pipeline.cache_manager.check_cache_exists(flow_dir, n)
    if not ok:
        print(f"Cache incomplete ({len(missing)} frames missing) — computing flow first...")
        pipeline.process_video()
    # LOD audit before handing off to the viewer (flow_processor.py:1496).
    pipeline.cache_manager.print_lod_cache_statistics(flow_dir, n)

    inspector = FlowInspector(config.input, flow_dir, fast_mode=config.fast, max_frames=n, start_frame=start,
                              device=pipeline.device)
    try:
        app = FlowVisualizerApp(inspector)
    except Exception as e:
        print(f"Cannot start Tk visualizer ({e}).")
        print("Headless analysis is available via tpuflow_torch.tools.visualizer.FlowInspector.")
        stats = inspector.cache_statistics()
        print(f"Cache statistics: {stats}")
        return 1
    app.run()
    return 0


class FlowVisualizerApp:
    """Tk shell over FlowInspector: 3-panel view, zoom/pan, hover arrows,
    correction controls (flow_visualizer.py:996-1737)."""

    MAP_MODES = ("quality", "turbulence")

    def __init__(self, inspector: FlowInspector):
        import tkinter as tk
        from PIL import Image, ImageTk  # noqa: F401 (needed for rendering)

        self.tk = tk
        self.inspector = inspector
        self.root = tk.Tk()
        self.root.title("tpuflow_torch visualizer")
        self.frame_idx = 0
        self.zoom = 1.0
        self.pan = [0, 0]
        self._drag_origin = None
        self.map_mode = "quality"
        self.detail: Optional[Dict] = None  # detail-analysis overlay data
        self._build_ui()

    def _build_ui(self):
        tk = self.tk
        n = len(self.inspector.flow_files)

        top = tk.Frame(self.root)
        top.pack(fill="x")
        self.slider = tk.Scale(
            top, from_=0, to=max(0, n - 1), orient="horizontal",
            command=self._on_slide, label="frame",
        )
        self.slider.pack(fill="x", side="left", expand=True)

        btns = tk.Frame(self.root)
        btns.pack(fill="x")
        tk.Button(btns, text="quality/turbulence", command=self._toggle_map).pack(side="left")
        tk.Button(btns, text="correct frame", command=self._correct_current).pack(side="left")
        tk.Button(btns, text="correct all", command=self._correct_all).pack(side="left")
        tk.Button(
            btns, text="Run TAA",
            command=lambda: run_taa_with_flow(self.inspector.video_path, self.inspector.flow_dir),
        ).pack(side="left")
        self.status = tk.Label(self.root, text="", anchor="w")
        self.status.pack(fill="x")

        tk.Button(btns, text="check consistency", command=self._check_consistency).pack(side="left")

        self.canvas = tk.Canvas(self.root, width=3 * 420, height=360, bg="black")
        self.canvas.pack(fill="both", expand=True)
        self.canvas.bind("<Motion>", self._on_hover)
        self.canvas.bind("<Button-1>", self._on_click)
        self.canvas.bind("<Double-Button-1>", self._on_double_click)
        self.canvas.bind("<MouseWheel>", self._on_wheel)
        self.canvas.bind("<Button-4>", lambda e: self._zoom_by(1.1))
        self.canvas.bind("<Button-5>", lambda e: self._zoom_by(1 / 1.1))
        # Pan: drag with the right mouse button (flow_visualizer.py pan).
        self.canvas.bind("<ButtonPress-3>", self._pan_start)
        self.canvas.bind("<B3-Motion>", self._pan_move)
        self._render()

    # -- pan ----------------------------------------------------------------
    def _pan_start(self, e):
        self._drag_origin = (e.x - self.pan[0], e.y - self.pan[1])

    def _pan_move(self, e):
        if self._drag_origin is not None:
            self.pan = [e.x - self._drag_origin[0], e.y - self._drag_origin[1]]
            self._render()

    def _zoom_by(self, f):
        self.zoom = min(5.0, max(0.1, self.zoom * f))
        self._render()

    def _on_wheel(self, e):
        self._zoom_by(1.1 if e.delta > 0 else 1 / 1.1)

    def _on_slide(self, val):
        self.frame_idx = int(val)
        self._render()

    def _toggle_map(self):
        i = self.MAP_MODES.index(self.map_mode)
        self.map_mode = self.MAP_MODES[(i + 1) % len(self.MAP_MODES)]
        self._render()

    def _panel_images(self):
        ins = self.inspector
        i = self.frame_idx
        if self.map_mode == "quality":
            # Deferred quality compute (flow_visualizer.py:601-658): show a
            # placeholder immediately; the worker re-renders when ready.
            third = ins.quality_map_cached(i)
            if third is None:
                third = np.zeros_like(ins.frames[i])
                ins.compute_quality_async(i, on_ready=self._on_quality_ready)
        else:
            third = ins.turbulence_map(i)
        return [ins.frames[i], ins.frames[i + 1], third]

    def _on_quality_ready(self, idx, _qmap):
        # Worker thread -> Tk main loop.
        self.root.after(0, lambda: idx == self.frame_idx and self._render())

    @staticmethod
    def _quality_color(q: float) -> str:
        if q >= corr_mod.GOOD_QUALITY_THRESHOLD:
            return "#00dd00"
        if q >= 0.5:
            return "#dddd00"
        return "#dd2200"

    def _render(self):
        from PIL import Image, ImageTk

        self.canvas.delete("all")
        self._photo_refs = []
        w = int(420 * self.zoom)
        for k, img in enumerate(self._panel_images()):
            pil = Image.fromarray(img)
            scale = w / pil.width
            pil = pil.resize((w, int(pil.height * scale)))
            photo = ImageTk.PhotoImage(pil)
            self._photo_refs.append(photo)
            self.canvas.create_image(
                k * (w + 4) + self.pan[0], self.pan[1], image=photo, anchor="nw"
            )
        self._render_detail_overlay()

    def _render_detail_overlay(self):
        """Detail-analysis overlay (flow_visualizer.py:2101-2349): source /
        current-target / corrected-target patches magnified in a corner
        panel with similarity annotations."""
        if self.detail is None:
            return
        from PIL import Image, ImageTk

        d = self.detail
        mag, pad = 4, 6
        x0, y0 = 8, 8
        labels = (
            ("source", d["source_patch"], None),
            ("current", d["target_patch"], d["current_similarity"]),
            ("corrected", d["corrected_patch"], d["corrected_similarity"]),
        )
        ps = d["source_patch"].shape[0] * mag
        self.canvas.create_rectangle(
            x0 - 4, y0 - 4, x0 + 3 * (ps + pad) + 4, y0 + ps + 36,
            fill="#222222", outline="#888888",
        )
        for k, (label, patch, sim) in enumerate(labels):
            pil = Image.fromarray(patch).resize((ps, ps), Image.NEAREST)
            photo = ImageTk.PhotoImage(pil)
            self._photo_refs.append(photo)
            px = x0 + k * (ps + pad)
            self.canvas.create_image(px, y0, image=photo, anchor="nw")
            text = label if sim is None else f"{label} {sim:.3f}"
            color = "#ffffff" if sim is None else self._quality_color(sim)
            self.canvas.create_text(
                px + ps // 2, y0 + ps + 14, text=text, fill=color
            )
        fx, fy = d["corrected_flow"]
        self.canvas.create_text(
            x0 + 1.5 * (ps + pad), y0 + ps + 30,
            text=f"pixel {d['pixel']} corrected flow ({fx:+.2f},{fy:+.2f})",
            fill="#cccccc",
        )

    def _canvas_to_pixel(self, ex, ey):
        w = int(420 * self.zoom)
        panel = int((ex - self.pan[0]) // (w + 4))
        px = (ex - self.pan[0]) % (w + 4)
        scale = w / self.inspector.width
        return panel, int(px / scale), int((ey - self.pan[1]) / scale)

    def _on_hover(self, e):
        panel, x, y = self._canvas_to_pixel(e.x, e.y)
        if 0 <= x < self.inspector.width and 0 <= y < self.inspector.height:
            fx, fy = self.inspector.sample_flow(self.frame_idx, x, y)
            q = self.inspector.pixel_quality(self.frame_idx, x, y)
            self.status.config(
                text=f"({x},{y}) flow=({fx:+.2f},{fy:+.2f}) quality={q:.3f}"
            )
            self._draw_hover_arrow(x, y, fx, fy, q)

    def _draw_hover_arrow(self, x, y, fx, fy, q):
        """Source->target arrow on the frame-N panel, colored by quality
        (flow_visualizer.py:1621-1737).  Target = source - flow (backward
        warp convention, tools/correction.py)."""
        self.canvas.delete("hover_arrow")
        w = int(420 * self.zoom)
        scale = w / self.inspector.width
        sx = x * scale + self.pan[0]
        sy = y * scale + self.pan[1]
        tx = (x - fx) * scale + self.pan[0]
        ty = (y - fy) * scale + self.pan[1]
        color = self._quality_color(q)
        self.canvas.create_line(
            sx, sy, tx, ty, fill=color, width=2, arrow="last", tags="hover_arrow"
        )
        # Same arrow on the frame-N+1 panel at the target location.
        self.canvas.create_line(
            sx + (w + 4), sy, tx + (w + 4), ty,
            fill=color, width=1, arrow="last", tags="hover_arrow", dash=(3, 2),
        )

    def _on_click(self, e):
        panel, x, y = self._canvas_to_pixel(e.x, e.y)
        if 0 <= x < self.inspector.width and 0 <= y < self.inspector.height:
            res = self.inspector.analyze_pixel(self.frame_idx, x, y)
            c = res["coarse"]
            msg = f"coarse: flow=({c['flow'][0]:+.2f},{c['flow'][1]:+.2f}) sim={c['similarity']:.3f}"
            if res["fine"] is not None:
                f = res["fine"]
                msg += f" | fine: flow=({f['flow'][0]:+.2f},{f['flow'][1]:+.2f}) sim={f['similarity']:.3f}"
            self.status.config(text=msg)

    def _on_double_click(self, e):
        """Toggle the detail-analysis overlay at the clicked pixel."""
        panel, x, y = self._canvas_to_pixel(e.x, e.y)
        if self.detail is not None:
            self.detail = None
        elif 0 <= x < self.inspector.width and 0 <= y < self.inspector.height:
            self.detail = self.inspector.detail_analysis(self.frame_idx, x, y)
        self._render()

    def _check_consistency(self):
        """Single-vs-batch correction consistency (flow_visualizer.py:940-959)
        at the frame center."""
        x, y = self.inspector.width // 2, self.inspector.height // 2
        res = self.inspector.consistency_check(self.frame_idx, x, y)
        verdict = "OK" if res["consistent"] else "INCONSISTENT"
        self.status.config(
            text=f"single-vs-batch at ({x},{y}): {verdict} "
            f"(Δtarget={res['target_delta'].max():.4f}, Δsim={res['similarity_delta']:.4f})"
        )

    def _correct_current(self):
        self.inspector.correct_range(self.frame_idx, self.frame_idx + 1)
        self.status.config(text=f"corrected frame {self.frame_idx} -> *_corrected/")

    def _correct_all(self):
        self.inspector.correct_range(0, len(self.inspector.flow_files))
        self.status.config(text="corrected all frames -> *_corrected/")

    def run(self):
        self.root.mainloop()
