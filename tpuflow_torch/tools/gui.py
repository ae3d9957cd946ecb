"""GUI launcher: builds and spawns the port's CLI from a form (a copy of
the JAX package's tools/gui.py that runs `tpuflow_torch.tools.cli`).

The reference's gui_runner.py (1893 LoC PyQt6 + qfluentwidgets) exposes a
form over every CLI flag, live filename/cache previews, a cache-status
badge, QSettings persistence, and launches the CLI in a new console
(gui_runner.py:142-1857).  Here the logic lives in a headless core:

- `GuiSettings` + JSON persistence   (QSettings parity, gui_runner.py:648-776)
- `build_command`                    (CLI string builder, gui_runner.py:1686-1780)
- `preview_output_path` / `preview_cache_path` + `cache_status`
  (filename previews and cache probe, gui_runner.py:1039-1124, 1317-1433)
- `load_video_preview` / async       (VideoThread, gui_runner.py:87-109)
- `ProcessRunner`                    (ProcessThread streamed stdout,
                                      gui_runner.py:111-139)

with a thin Tk shell (`FlowRunnerApp`) on top — PyQt6 is not assumed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from ..pipeline.filenames import generate_cache_directory, generate_output_filename

SETTINGS_PATH = os.path.expanduser("~/.tpuflow_torch_gui.json")


@dataclass
class GuiSettings:
    """Every CLI-visible option the form exposes (gui_runner.py:236-259)."""

    input: str = ""
    output: str = "results"
    device: str = "auto"
    frames: int = 1000
    start_frame: int = 0
    start_time: Optional[float] = None
    duration: Optional[float] = None
    fast: bool = False
    tile: bool = False
    flow_only: bool = False
    taa: bool = False
    force_recompute: bool = False
    uncompressed: bool = False
    skip_lods: bool = False
    no_autoplay: bool = False
    flow_format: str = "gamedev"
    motion_vectors_clamp_range: float = 32.0
    sequence_length: int = 5
    save_flow: Optional[str] = None
    use_flow_cache: Optional[str] = None
    model: str = "videoflow"
    stage: str = "sintel"
    vf_dataset: str = "sintel"
    vf_architecture: str = "mof"
    vf_variant: str = "standard"

    def save(self, path: str = SETTINGS_PATH) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str = SETTINGS_PATH) -> "GuiSettings":
        if not os.path.exists(path):
            return cls()
        try:
            with open(path) as f:
                data = json.load(f)
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in data.items() if k in known})
        except Exception:
            return cls()


def build_command(s: GuiSettings, python: str = sys.executable) -> List[str]:
    """CLI argv from settings (gui_runner.py:1686-1780 builds the same
    string for PowerShell; argv avoids the quoting problems)."""
    cmd = [python, "-m", "tpuflow_torch.tools.cli", "--input", s.input, "--output", s.output]
    if s.device != "auto":
        cmd += ["--device", s.device]
    if s.frames != 1000:
        cmd += ["--frames", str(s.frames)]
    if s.start_frame:
        cmd += ["--start-frame", str(s.start_frame)]
    if s.start_time is not None:
        cmd += ["--start-time", str(s.start_time)]
    if s.duration is not None:
        cmd += ["--duration", str(s.duration)]
    for flag, on in (
        ("--fast", s.fast),
        ("--tile", s.tile),
        ("--flow-only", s.flow_only),
        ("--taa", s.taa),
        ("--force-recompute", s.force_recompute),
        ("--uncompressed", s.uncompressed),
        ("--skip-lods", s.skip_lods),
        ("--no-autoplay", s.no_autoplay),
    ):
        if on:
            cmd.append(flag)
    if s.flow_format != "gamedev":
        cmd += ["--flow-format", s.flow_format]
    if s.motion_vectors_clamp_range != 32.0:
        cmd += ["--motion-vectors-clamp-range", str(s.motion_vectors_clamp_range)]
    if s.sequence_length != 5:
        cmd += ["--sequence-length", str(s.sequence_length)]
    if s.save_flow:
        cmd += ["--save-flow", s.save_flow]
    if s.use_flow_cache:
        cmd += ["--use-flow-cache", s.use_flow_cache]
    if s.model != "videoflow":
        cmd += ["--model", s.model]
    if s.stage != "sintel":
        cmd += ["--stage", s.stage]
    if s.vf_dataset != "sintel":
        cmd += ["--vf-dataset", s.vf_dataset]
    if s.vf_architecture != "mof":
        cmd += ["--vf-architecture", s.vf_architecture]
    if s.vf_variant != "standard":
        cmd += ["--vf-variant", s.vf_variant]
    return cmd


def preview_output_path(s: GuiSettings, fps: float = 30.0) -> str:
    """Output filename preview (gui_runner.py:1317-1433 reuses the same
    generator)."""
    name = generate_output_filename(
        s.input,
        start_time=s.start_time,
        duration=s.duration,
        start_frame=s.start_frame,
        max_frames=s.frames,
        flow_only=s.flow_only,
        taa=s.taa,
        fast_mode=s.fast,
        tile_mode=s.tile,
        uncompressed=s.uncompressed,
        flow_format=s.flow_format,
        motion_vectors_clamp_range=s.motion_vectors_clamp_range,
        fps=fps,
    )
    return os.path.join(s.output, name)


def preview_cache_path(s: GuiSettings) -> str:
    return generate_cache_directory(
        s.input,
        start_frame=s.start_frame,
        max_frames=s.frames,
        sequence_length=s.sequence_length,
        fast_mode=s.fast,
        tile_mode=s.tile,
        model=s.model,
        dataset=s.vf_dataset if s.model == "videoflow" else s.stage,
        architecture=s.vf_architecture,
        variant=s.vf_variant,
    )


def cache_status(s: GuiSettings) -> Tuple[str, str]:
    """(state, detail): cache badge (gui_runner.py:1039-1124).
    States: 'none' | 'partial' | 'complete'."""
    from ..pipeline.cache import FlowCacheManager

    cache_dir = s.use_flow_cache or preview_cache_path(s)
    if not os.path.isdir(cache_dir):
        return "none", f"no cache at {cache_dir}"
    ok, fmt, missing = FlowCacheManager().check_cache_exists(cache_dir, s.frames)
    if ok:
        return "complete", f"complete ({fmt}) at {cache_dir}"
    found = s.frames - len(missing)
    return "partial", f"{found}/{s.frames} frames at {cache_dir}"


def launch_cli(s: GuiSettings) -> subprocess.Popen:
    """Spawn the CLI (the reference opens a new PowerShell console,
    gui_runner.py:1826-1857; POSIX just runs the child)."""
    return subprocess.Popen(build_command(s))


# ---------------------------------------------------------------------------
# Background video preview (VideoThread, gui_runner.py:87-109)
# ---------------------------------------------------------------------------
class VideoPreview(NamedTuple):
    frame: "object"        # first frame, RGB HxWx3 uint8 (numpy)
    total_frames: int
    fps: float


def load_video_preview(path: str) -> VideoPreview:
    """First frame + metadata of a video (the reference's VideoThread.run
    body: cv2 open, read frame count/fps, BGR->RGB first frame)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        ok, frame = cap.read()
        if not ok:
            raise IOError(f"cannot read first frame: {path}")
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()
    return VideoPreview(frame=frame, total_frames=total, fps=fps)


def load_video_preview_async(
    path: str,
    on_loaded: Callable[[VideoPreview], None],
    on_error: Optional[Callable[[Exception], None]] = None,
) -> threading.Thread:
    """Non-blocking preview load: runs `load_video_preview` on a daemon
    thread and delivers the result via callback — the UI never freezes on
    video IO (gui_runner.py:87 'to prevent UI freezing')."""

    def work():
        try:
            on_loaded(load_video_preview(path))
        except Exception as e:  # surfaced, never swallowed silently
            if on_error is not None:
                on_error(e)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# Streaming process runner (ProcessThread, gui_runner.py:111-139)
# ---------------------------------------------------------------------------
class ProcessRunner:
    """Run an argv, streaming merged stdout/stderr lines to a callback
    from a reader thread, then report the return code.

    Mirrors the reference's ProcessThread: Popen with stdout=PIPE,
    stderr=STDOUT, line-buffered text; `output_received` per line,
    `process_finished(returncode)` at exit (gui_runner.py:119-139).
    Errors surface as an output line + returncode 1, like upstream.
    """

    def __init__(
        self,
        argv: List[str],
        on_output: Callable[[str], None],
        on_finished: Optional[Callable[[int], None]] = None,
    ):
        self.argv = argv
        self.on_output = on_output
        self.on_finished = on_finished
        self.process: Optional[subprocess.Popen] = None
        self.returncode: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ProcessRunner":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            self.process = subprocess.Popen(
                self.argv,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                universal_newlines=True,
                bufsize=1,
            )
            assert self.process.stdout is not None
            for line in iter(self.process.stdout.readline, ""):
                if line:
                    self.on_output(line.rstrip("\n"))
            self.process.wait()
            self.returncode = self.process.returncode
        except Exception as e:
            self.on_output(f"Error: {e}")
            self.returncode = 1
        if self.on_finished is not None:
            self.on_finished(self.returncode)

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self._thread is not None:
            self._thread.join(timeout)
        return self.returncode

    def stop(self) -> None:
        """Terminate the child (direct PID, never pattern-matched)."""
        if self.process is not None and self.process.poll() is None:
            self.process.terminate()


class FlowRunnerApp:
    """Thin Tk form over the headless core."""

    def __init__(self):
        import tkinter as tk
        from tkinter import filedialog, ttk

        self.tk, self.ttk, self.filedialog = tk, ttk, filedialog
        self.settings = GuiSettings.load()
        self.root = tk.Tk()
        self.root.title("tpuflow_torch runner")
        self._vars: Dict[str, object] = {}
        self._build()

    def _build(self):
        tk, ttk = self.tk, self.ttk
        s = self.settings
        row = 0

        def add_entry(label, key, width=48):
            nonlocal row
            tk.Label(self.root, text=label).grid(row=row, column=0, sticky="w")
            var = tk.StringVar(value=str(getattr(s, key) or ""))
            tk.Entry(self.root, textvariable=var, width=width).grid(row=row, column=1, sticky="we")
            self._vars[key] = var
            row += 1

        def add_check(label, key):
            nonlocal row
            var = tk.BooleanVar(value=getattr(s, key))
            tk.Checkbutton(self.root, text=label, variable=var).grid(row=row, column=0, columnspan=2, sticky="w")
            self._vars[key] = var
            row += 1

        def add_combo(label, key, values):
            nonlocal row
            tk.Label(self.root, text=label).grid(row=row, column=0, sticky="w")
            var = tk.StringVar(value=getattr(s, key))
            ttk.Combobox(self.root, textvariable=var, values=values).grid(row=row, column=1, sticky="we")
            self._vars[key] = var
            row += 1

        add_entry("Input video", "input")
        add_entry("Output dir", "output")
        add_entry("Frames", "frames", 12)
        add_entry("Start frame", "start_frame", 12)
        add_entry("Sequence length", "sequence_length", 12)
        add_combo("Model", "model", ["videoflow", "memflow"])
        add_combo("Architecture", "vf_architecture", ["mof", "bof"])
        add_combo("Dataset", "vf_dataset", ["sintel", "things", "kitti"])
        add_combo("Variant", "vf_variant", ["standard", "noise"])
        add_combo("Flow format", "flow_format",
                  ["gamedev", "hsv", "torchvision", "motion-vectors-rg8", "motion-vectors-rgb8"])
        for label, key in [
            ("fast", "fast"), ("tile", "tile"), ("flow only", "flow_only"),
            ("TAA", "taa"), ("force recompute", "force_recompute"),
            ("uncompressed", "uncompressed"), ("skip LODs", "skip_lods"),
        ]:
            add_check(label, key)

        self.preview = tk.Label(self.root, text="", anchor="w", justify="left")
        self.preview.grid(row=row, column=0, columnspan=2, sticky="we")
        row += 1
        self.video_info = tk.Label(self.root, text="", anchor="w")
        self.video_info.grid(row=row, column=0, columnspan=2, sticky="we")
        row += 1
        tk.Button(self.root, text="Preview", command=self._update_preview).grid(row=row, column=0)
        tk.Button(self.root, text="Run", command=self._run).grid(row=row, column=1)
        row += 1
        # Streamed CLI output (ProcessRunner -> queue -> after-poll; Tk
        # widgets are only touched from the main thread).
        self.output = tk.Text(self.root, height=12, width=80, state="disabled")
        self.output.grid(row=row, column=0, columnspan=2, sticky="we")
        import queue as _queue

        self._outq: "_queue.Queue[str]" = _queue.Queue()
        self._runner = None
        self.root.after(100, self._drain_output)

    def _drain_output(self):
        try:
            while True:
                line = self._outq.get_nowait()
                if line.startswith("[video] "):
                    self.video_info.config(text=line[len("[video] "):])
                self.output.config(state="normal")
                self.output.insert("end", line + "\n")
                self.output.see("end")
                self.output.config(state="disabled")
        except Exception:
            pass
        self.root.after(100, self._drain_output)

    def _collect(self) -> GuiSettings:
        s = self.settings
        for key, var in self._vars.items():
            val = var.get()
            cur = getattr(s, key)
            if isinstance(cur, bool):
                setattr(s, key, bool(val))
            elif isinstance(cur, int):
                setattr(s, key, int(val or 0))
            elif isinstance(cur, float):
                setattr(s, key, float(val or 0))
            else:
                setattr(s, key, val or None if key in ("save_flow", "use_flow_cache") else val)
        return s

    def _update_preview(self):
        s = self._collect()
        state, detail = cache_status(s)
        self.preview.config(
            text=(
                f"output: {preview_output_path(s)}\n"
                f"cache:  {preview_cache_path(s)}\n"
                f"status: {state} — {detail}\n"
                f"cmd:    {' '.join(build_command(s))}"
            )
        )
        if s.input and os.path.exists(s.input):
            # Background load (VideoThread parity); result lands in the
            # output queue and the info label via the after-poll.
            def loaded(p: VideoPreview):
                h, w = p.frame.shape[:2]
                self._outq.put(
                    f"[video] {w}x{h}, {p.total_frames} frames @ {p.fps:.2f} fps"
                )

            load_video_preview_async(
                s.input, loaded, lambda e: self._outq.put(f"[video] error: {e}")
            )

    def _run(self):
        s = self._collect()
        s.save()
        self._outq.put("$ " + " ".join(build_command(s)))
        self._runner = ProcessRunner(
            build_command(s),
            self._outq.put,
            lambda rc: self._outq.put(f"[exit {rc}]"),
        ).start()

    def run(self):
        self.root.mainloop()


def main() -> int:
    try:
        app = FlowRunnerApp()
    except Exception as e:
        print(f"Cannot start GUI ({e}). The headless API is available via "
              "tpuflow_torch.tools.gui (GuiSettings, build_command, launch_cli).")
        return 1
    app.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
