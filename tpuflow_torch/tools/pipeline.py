"""FlowPipeline — the end-to-end video orchestrator (the JAX package's
tools/pipeline.py on the port's engine and ops).

The analogue of the reference's `VideoFlowProcessor` facade +
`process_video` loop (flow_processor.py:42-1173):

- Flows are computed by the port's FlowEngine, on the card unless the
  configuration asks for the CPU: MemFlow streams the clip with its memory
  carried (`stream_flows`), VideoFlow runs stride-1 tiles
  (`compute_flows_tiled_stride1`), interior-stride windows
  (`compute_flows_strided`) or batches of centred windows
  (`compute_flow_batch`).
- Encoding and TAA run on the same device through pipeline/ops.py, with the
  TAA histories kept there between frames (`RenderStep`); composition and
  video writing stay on the host (cv2 owns the codecs).
- The per-frame `.npz`/`.flo` cache is written before any post-processing
  — the recovery-unit contract of the reference (flow_processor.py:975-976)
  — with the JAX package's directory naming and file layout, so either
  package finds the other's cache.

Behavioral contracts mirrored (each noted inline):
  cache probe / --use-flow-cache hard errors  flow_processor.py:780-800
  flow-input decode of bottom-half RG8/RGB8   flow_processor.py:436-488
  diff overlay radar colors + legend          flow_processor.py:490-578
  output grid sizes per mode                  flow_processor.py:895-917
  TAA uses previous frame's flow              flow_processor.py:1016-1112
  LOD generation after compute                flow_processor.py:1161-1168

`data_parallel` > 1 builds a mesh of min(data_parallel, cards) cards
(runtime/sharding.py) for the engine, as the JAX pipeline does; the
multi-process flow pass is `compute_flows_distributed` (the CLI's
--num-processes, runtime/distributed.py).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..pipeline import ops
from ..pipeline.cache import FlowCacheManager
from ..pipeline.filenames import generate_cache_directory, generate_output_filepath
from ..pipeline.video_io import FrameExtractor
from ..runtime.device import DeviceManager
from ..runtime.distributed import gather_host_results, host_window_range, rank, world_size
from ..runtime import profiling
from ..runtime.engine import FlowEngine
from ..runtime.sharding import make_mesh

try:
    import cv2

    from ..pipeline.compose import VideoComposer
except ImportError:  # pragma: no cover
    cv2 = VideoComposer = None


# Radar color levels for the flow-difference overlay
# (flow_processor.py:518-533).
DIFF_ERROR_LEVELS = [0.1, 0.5, 1.0, 2.0, 4.0]
DIFF_RADAR_COLORS = [
    (0, 255, 0),
    (255, 255, 0),
    (255, 165, 0),
    (255, 0, 0),
    (255, 0, 255),
]

TAA_ALPHA = 0.1


def create_difference_overlay(
    original_flow: np.ndarray, decoded_flow: np.ndarray
) -> np.ndarray:
    """Radar-colored error map with a small legend band
    (flow_processor.py:490-578)."""
    diff = original_flow - decoded_flow
    mag = np.sqrt(diff[:, :, 0] ** 2 + diff[:, :, 1] ** 2)
    h, w = mag.shape
    overlay = np.zeros((h, w, 3), dtype=np.uint8)

    for i, (level, color) in enumerate(zip(DIFF_ERROR_LEVELS, DIFF_RADAR_COLORS)):
        if i == 0:
            mask = mag <= level
        elif i == len(DIFF_ERROR_LEVELS) - 1:
            mask = mag > DIFF_ERROR_LEVELS[i - 1]
        else:
            mask = (mag > DIFF_ERROR_LEVELS[i - 1]) & (mag <= level)
        overlay[mask] = color

    # Legend: colored squares with white borders and labels.
    square, spacing, x0 = 12, 45, 10
    y0 = h - 20
    for i, (level, color) in enumerate(zip(DIFF_ERROR_LEVELS, DIFF_RADAR_COLORS)):
        x = x0 + i * spacing
        cv2.rectangle(overlay, (x - 1, y0 - square - 1), (x + square + 1, y0 + 1), (255, 255, 255), -1)
        cv2.rectangle(overlay, (x, y0 - square), (x + square, y0), color, -1)
        label = (
            f">{DIFF_ERROR_LEVELS[i-1]:.3f}"
            if i == len(DIFF_ERROR_LEVELS) - 1
            else f"{level:.3f}"
        )
        cv2.putText(overlay, label, (x + square + 4, y0 - 3), cv2.FONT_HERSHEY_SIMPLEX, 0.3, (0, 0, 0), 1)
        cv2.putText(overlay, label, (x + square + 3, y0 - 4), cv2.FONT_HERSHEY_SIMPLEX, 0.3, (255, 255, 255), 1)
    return overlay


class RenderStep:
    """The render loop's device work for one frame at a time: the frame and
    its flow (and the external flow) uploaded once, the flow encoded, and
    the three TAA histories (flow, simple, external flow) advanced and kept
    on the device between frames.  TAA warps along the *previous* frame's
    flow (flow_processor.py:1018, 1112), kept on the device from the last
    call.  Returns what the composer needs, on the host: the encoded flows
    as uint8 and the TAA frames as the composer's uint8 (clip, truncate)."""

    def __init__(self, device: torch.device, width: int, height: int, flow_format: str,
                 clamp_range: float, taa: bool):
        self.device = device
        self.width, self.height = width, height
        self.flow_format, self.clamp_range = flow_format, clamp_range
        self.taa = taa
        self.prev_flow: Optional[torch.Tensor] = None
        self.hist: Dict[str, Optional[torch.Tensor]] = {"flow": None, "simple": None, "ext": None}

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _encode(self, flow: torch.Tensor) -> torch.Tensor:
        return ops.encode_flow(flow, self.width, self.height, self.flow_format, self.clamp_range)

    def _advance(self, key: str, frame: torch.Tensor, flow: Optional[torch.Tensor]) -> torch.Tensor:
        hist = self.hist[key]
        if hist is None:
            hist = frame
        else:
            hist = ops.taa_step(frame, flow, hist, alpha=TAA_ALPHA, use_flow=flow is not None)
        self.hist[key] = hist
        return hist

    def __call__(self, frame: np.ndarray, flow: np.ndarray, ext_flow: Optional[np.ndarray] = None) -> Dict:
        frame_f32 = self._upload(frame).float()
        flow_t = self._upload(flow)
        out = {"flow_viz": self._encode(flow_t)}
        if self.taa:
            out["taa_frame"] = self._advance("flow", frame_f32, self.prev_flow)
            out["taa_simple_frame"] = self._advance("simple", frame_f32, None)
            if ext_flow is not None:
                ext_t = self._upload(ext_flow)
                out["taa_ext_frame"] = self._advance("ext", frame_f32, ext_t)
                out["ext_viz"] = self._encode(ext_t)
        self.prev_flow = flow_t
        return {k: ops.to_uint8(v).cpu().numpy() for k, v in out.items()}


class FlowPipeline:
    """End-to-end orchestrator (facade parity: flow_processor.py:42-120)."""

    def __init__(self, config: PipelineConfig, engine: Optional[FlowEngine] = None,
                 trace_dir: Optional[str] = None):
        """`trace_dir`: run the flow pass with the spans on, under the
        profiler, and write its trace and spans.json there
        (runtime/profiling.trace_to; the CLI's --trace-dir)."""
        self.config = config
        self.trace_dir = trace_dir
        self.device = DeviceManager.get_device(config.device)
        mesh = None
        if engine is None and config.data_parallel > 1:
            n = min(config.data_parallel, torch.cuda.device_count() if self.device.type == "cuda" else 1)
            if n > 1:
                mesh = make_mesh(n)
                print(f"[Parallel] sharding window batches over {n} devices")
        self.engine = engine or FlowEngine(config.model_config(), device=self.device, mesh=mesh)
        self.cache_manager = FlowCacheManager()
        self.composer = VideoComposer() if VideoComposer is not None else None
        self.model_label = (
            f"{config.vf_architecture.upper()}_{config.vf_dataset}"
            if config.model == "videoflow"
            else f"MemFlowNet_{config.stage}"
        )

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def cache_dir_for(self, input_path: str, start_frame: int, n_frames: int) -> str:
        c = self.config
        return generate_cache_directory(
            input_path=input_path,
            start_frame=start_frame,
            max_frames=n_frames,
            sequence_length=c.sequence_length,
            fast_mode=c.fast,
            tile_mode=c.tile,
            model=c.model,
            dataset=c.vf_dataset if c.model == "videoflow" else c.stage,
            architecture=c.vf_architecture,
            variant=c.vf_variant,
        )

    def extract_flow_from_video(
        self, video_path: str, max_frames: int, flow_format: str
    ) -> List[np.ndarray]:
        """Decode RG8/RGB8 motion vectors from the bottom half of an
        encoded comparison video (flow_processor.py:436-488), on the
        pipeline's device."""
        extractor = FrameExtractor(video_path, fast_mode=self.config.fast)
        frames, _, _, height, _ = extractor.extract_frames(max_frames=max_frames, progress=False)
        original_height = height // 2
        variant = "rg8" if flow_format == "motion-vectors-rg8" else "rgb8"
        if flow_format not in ("motion-vectors-rg8", "motion-vectors-rgb8"):
            raise ValueError(f"Unsupported flow format: {flow_format}")
        decode = (
            ops.decode_motion_vectors_rg8
            if variant == "rg8"
            else ops.decode_motion_vectors_rgb8
        )
        out = []
        for frame in frames:
            encoded = torch.from_numpy(np.ascontiguousarray(frame[original_height:, :, :])).to(self.device)
            out.append(decode(encoded, self.config.motion_vectors_clamp_range).cpu().numpy())
        return out

    # ------------------------------------------------------------------
    # flow computation phase
    # ------------------------------------------------------------------
    def compute_all_flows(
        self,
        frames: List[np.ndarray],
        cache_dir: Optional[str],
        cache_format: str = "npz",
        progress: bool = True,
    ) -> List[np.ndarray]:
        """Compute flow for every frame, writing the cache as results land
        (recovery-unit contract, flow_processor.py:975-976).  Cache writes
        (FlowCacheManager.save_flow_to_cache, numpy) run on a pool of four
        threads, so that they overlap the device's work; every write has
        finished, and its error has been raised, when this returns."""
        import concurrent.futures as cf

        n = len(frames)
        flows: List[Optional[np.ndarray]] = [None] * n
        io_pool = cf.ThreadPoolExecutor(max_workers=4) if cache_dir else None
        io_futures = []

        def save(flow, idx):
            if not cache_dir:
                return
            io_futures.append(
                io_pool.submit(
                    self.cache_manager.save_flow_to_cache, flow, cache_dir, idx, cache_format
                )
            )

        iterator = None
        if progress:
            try:
                from tqdm import tqdm

                iterator = tqdm(total=n, desc=f"{self.model_label} processing", unit="frame")
            except ImportError:
                pass

        name = "spans.json" if world_size() == 1 else f"spans.rank{rank()}.json"
        with profiling.trace_to(self.trace_dir, name):
            if self.config.model == "memflow":
                # One stream over the clip with the memory carried.
                all_flows = self.engine.stream_flows(frames)
                for i in range(n):
                    flows[i] = all_flows[i]
                    save(flows[i], i)
                    if iterator:
                        iterator.update(1)
            elif self.config.stride_mode == "interior" and not self.config.tile:
                all_flows = self.engine.compute_flows_strided(
                    frames, window_batch=max(1, self.config.batch_frames)
                )
                for i in range(n):
                    flows[i] = all_flows[i]
                    save(flows[i], i)
                    if iterator:
                        iterator.update(1)
            elif self.config.tile:
                # Stride-1 tile mode: each frame's encoder features are
                # computed once and reused by the windows that share it.
                def _on_frame(i, flow):
                    flows[i] = flow
                    save(flow, i)
                    if iterator:
                        iterator.update(1)

                self.engine.compute_flows_tiled_stride1(
                    frames, overlap=self.config.tile_overlap, progress_cb=_on_frame
                )
            else:
                bs = max(1, self.config.batch_frames)
                for i0 in range(0, n, bs):
                    idxs = list(range(i0, min(n, i0 + bs)))
                    batch = self.engine.compute_flow_batch(frames, idxs)
                    for j, i in enumerate(idxs):
                        flows[i] = batch[j]
                        save(flows[i], i)
                    if iterator:
                        iterator.update(len(idxs))

        if io_pool is not None:
            for fut in io_futures:
                fut.result()  # surface write errors
            io_pool.shutdown()
        if iterator:
            iterator.close()
        return flows  # type: ignore[return-value]

    def compute_flows_distributed(self, input_path: Optional[str] = None) -> str:
        """Multi-process flow pass (tpuflow/tools/pipeline.py:254-330): each
        process decodes and computes its own contiguous frame range (with
        the windows' context, one frame more on the left than the JAX
        package's, or MemFlow's memory warm-up prefix) and
        writes its disjoint slice of the shared flow cache; a scalar
        all-reduce confirms completion.  Rendering stays a one-process step
        over the completed cache.  Returns the cache directory.  Needs
        runtime/distributed.init_distributed (the CLI's --num-processes); a
        single process computes the whole range."""
        from ..pipeline.video_io import VideoInfo

        c = self.config
        input_path = input_path or c.input
        total = VideoInfo(input_path).get_frame_count() - c.start_frame
        n = min(c.frames, total)
        half = c.sequence_length // 2
        # One frame more on the left than a centred window reaches: a slice
        # that starts at an owned window's first frame would replicate that
        # window's edge at the front, as at the clip's start, where the whole
        # clip replicates it at the end (windows.centered_window_indices;
        # 8 frames over 4 processes, frame 6).  The JAX package decodes
        # (half, half) and has that fault.
        context = (half + 1, half)
        if c.model == "memflow":
            # The memory ring holds the last `memory_capacity` frames'
            # tokens: replaying twice that many frames before the first
            # owned output brings the carried state back to the one-process
            # stream's; a process whose prefix reaches frame 0 matches it
            # exactly.
            warmup = max(half, 2 * self.engine.config.memory_capacity)
            context = (warmup, half)
        (dec_lo, dec_hi), (out_lo, out_hi) = host_window_range(n, c.sequence_length, context=context)
        print(
            f"[Distributed] process {rank()}/{world_size()}: "
            f"decode frames [{dec_lo}, {dec_hi}), own flows [{out_lo}, {out_hi})"
        )
        if c.model == "memflow" and world_size() > 1:
            print(
                f"[Distributed] MemFlow memory warm-up: replaying {out_lo - dec_lo} context frames "
                "before the first owned output (memory converges to the one-process stream)"
            )

        extractor = FrameExtractor(input_path, fast_mode=c.fast)
        frames, _, _, _, _ = extractor.extract_frames(
            max_frames=dec_hi - dec_lo,
            start_frame=c.start_frame + dec_lo,
        )

        self.engine.load_model(c.model_path, allow_random_init=c.allow_random_init)
        cache_dir = self.cache_dir_for(input_path, c.start_frame, n)
        cache_format = c.save_flow if c.save_flow else "npz"

        # Compute over the decoded slice (context included), keep only the
        # owned range, write it at the video's frame indices.
        flows = self.compute_all_flows(frames, cache_dir=None, progress=False)
        for i in range(out_lo, out_hi):
            self.cache_manager.save_flow_to_cache(flows[i - dec_lo], cache_dir, i, cache_format)

        done = gather_host_results(out_hi - out_lo)
        print(f"[Distributed] {done}/{n} flows complete across processes")
        if done != n:
            raise RuntimeError(f"Distributed flow pass incomplete: {done}/{n} frames")
        return cache_dir

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------
    def process_video(self, input_path: Optional[str] = None, output_path: Optional[str] = None) -> str:
        c = self.config
        input_path = input_path or c.input
        output_path = output_path or c.output

        extractor = FrameExtractor(input_path, fast_mode=c.fast)
        frames, fps, width, height, actual_start = extractor.extract_frames(
            max_frames=c.frames,
            start_frame=c.start_frame,
            start_time=c.start_time,
            duration=c.duration,
        )
        n = len(frames)

        taa = c.taa
        flow_input = c.flow_input
        if flow_input is not None and not taa:
            print("Warning: --flow-input requires --taa to be enabled. Enabling TAA mode.")
            taa = True

        # If the given output path is itself a complete flow cache, use it
        # as the cache and derive a fresh video path next to it
        # (flow_processor.py:806-820).
        output_is_cache = False
        if (
            c.use_flow_cache is None
            and os.path.isdir(output_path)
            and self.cache_manager.check_cache_exists(output_path, n)[0]
        ):
            print(f"Detected existing flow cache at output path: {output_path}")
            cache_as_output = output_path
            output_path = os.path.join(
                os.path.dirname(output_path),
                f"{os.path.basename(output_path)}_taa_output.avi",
            )
            print(f"Video will be saved to: {output_path}")
            output_is_cache = True

        if not output_is_cache and os.path.isdir(output_path):
            output_path = generate_output_filepath(
                input_path,
                output_path,
                start_time=c.start_time,
                duration=c.duration,
                start_frame=c.start_frame,
                max_frames=c.frames,
                flow_only=c.flow_only,
                taa=taa,
                fast_mode=c.fast,
                tile_mode=c.tile,
                uncompressed=c.uncompressed,
                flow_format=c.flow_format,
                motion_vectors_clamp_range=c.motion_vectors_clamp_range,
                fps=fps,
            )
            print(f"Auto-generated output filename: {os.path.basename(output_path)}")

        print(f"Processing: {input_path} -> {output_path}")

        # -- external flow (flow_processor.py:726-760) ----------------------
        decoded_flows = None
        if flow_input is not None:
            if not os.path.exists(flow_input):
                raise ValueError(f"Flow input video not found: {flow_input}")
            decoded_flows = self.extract_flow_from_video(flow_input, n, c.flow_format)
            if not decoded_flows:
                raise ValueError("No flow data could be extracted from flow input video")
            while len(decoded_flows) < n:  # extend with last (:752-757)
                decoded_flows.append(decoded_flows[-1].copy())
            decoded_flows = decoded_flows[:n]

        # -- cache resolution (flow_processor.py:763-833) -------------------
        use_cached = False
        cached_format = None
        if output_is_cache:
            cache_dir = cache_as_output
            _, cached_format, _ = self.cache_manager.check_cache_exists(cache_dir, n)
            use_cached = True
            print(f"Using optical flow cache from: {cache_dir} (format: {cached_format})")
        elif c.use_flow_cache is not None:
            cache_dir = c.use_flow_cache
            ok, cached_format, missing = self.cache_manager.check_cache_exists(cache_dir, n)
            if not ok:
                if not os.path.exists(cache_dir):
                    msg = (
                        f"Error: The specified cache directory does not exist.\n"
                        f"  Directory: {cache_dir}\n"
                        "  Please provide a valid path for '--use-flow-cache'."
                    )
                else:
                    msg = (
                        f"Error: The specified cache directory is incomplete.\n"
                        f"  Directory: {cache_dir}\n"
                        f"  Reason: Found {n - len(missing)} of {n} required flow files.\n"
                        f"  Missing frame indices: {missing[:10]}{'...' if len(missing) > 10 else ''}"
                    )
                print(msg, file=sys.stderr)
                raise SystemExit(1)
            use_cached = True
            print(f"Using optical flow cache from: {cache_dir} (format: {cached_format})")
        else:
            cache_dir = self.cache_dir_for(input_path, c.start_frame, n)
            if not c.force_recompute:
                ok, cached_format, _ = self.cache_manager.check_cache_exists(cache_dir, n)
                if ok:
                    use_cached = True
                    print(f"Found existing optical flow cache: {cache_dir} (format: {cached_format})")
                else:
                    print(f"No existing cache found, will compute and save to: {cache_dir}")
            else:
                print(f"Force recompute enabled, will overwrite cache: {cache_dir}")

        # LODs for cached flow (flow_processor.py:838-852)
        if use_cached and not c.skip_lods:
            if not self.cache_manager.check_flow_lods_exist(cache_dir, n):
                print("LOD pyramids not found, generating...")
                self.cache_manager.generate_lods_for_cache(cache_dir, n)
            # Per-level cache audit on cache hit (flow_processor.py:850).
            self.cache_manager.print_lod_cache_statistics(cache_dir, n)

        # -- flows ----------------------------------------------------------
        if use_cached:
            flows = [
                self.cache_manager.load_cached_flow(cache_dir, i, cached_format)
                for i in range(n)
            ]
        else:
            print(f"[Model] {self.model_label} on {self.device}")
            loaded_from = self.engine.load_model(
                c.model_path, allow_random_init=c.allow_random_init
            )
            print(f"[Model] parameters: {loaded_from}")
            cache_format = c.save_flow if c.save_flow else "npz"
            flows = self.compute_all_flows(frames, cache_dir, cache_format)

        # Explicit --save-flow directory (flow_processor.py:874-886)
        if c.save_flow is not None:
            out_dir = os.path.dirname(output_path)
            out_name = os.path.splitext(os.path.basename(output_path))[0]
            flow_dir = os.path.join(out_dir, f"{out_name}_flow")
            os.makedirs(flow_dir, exist_ok=True)
            base = os.path.join(flow_dir, "flow")
            for i, fl in enumerate(flows):
                self.cache_manager.save_optical_flow_files(fl, base, i, c.save_flow)
            print(f"Saved optical flow to: {flow_dir}")

        # -- output video ----------------------------------------------------
        if c.flow_only:
            output_size = (width, height * 2)
        elif taa:
            output_size = (width * 2, height * 3) if flow_input else (width * 2, height * 2)
        else:
            output_size = (width * 2, height)

        fourcc = 0 if c.uncompressed else cv2.VideoWriter_fourcc(*"MJPG")
        out = cv2.VideoWriter(output_path, fourcc, fps, output_size)
        if not out.isOpened():
            raise ValueError(f"Cannot create output video: {output_path}")

        self._render_loop(frames, flows, decoded_flows, out, width, height, taa)
        out.release()

        # LODs for freshly computed flow (flow_processor.py:1161-1168)
        if not use_cached and cache_dir and not c.skip_lods:
            print("Generating LOD pyramids for computed flow...")
            self.cache_manager.generate_lods_for_cache(cache_dir, n)
            # Audit report after generation (flow_processor.py:1167).
            self.cache_manager.print_lod_cache_statistics(cache_dir, n)

        if not c.no_autoplay:
            self.auto_play_video(output_path)
        return output_path

    # ------------------------------------------------------------------
    def _render_loop(self, frames, flows, decoded_flows, out, width, height, taa):
        """Encode + TAA on the device (RenderStep), compose + write on the
        host."""
        c = self.config
        n = len(frames)
        step = RenderStep(self.device, width, height, c.flow_format, c.motion_vectors_clamp_range, taa)

        try:
            from tqdm import tqdm

            pbar = tqdm(total=n, desc=f"{self.model_label} rendering", unit="frame")
        except ImportError:
            pbar = None

        for i in range(n):
            flow = flows[i]
            # process_video turns TAA on whenever there is an external flow.
            ext_flow = decoded_flows[i] if decoded_flows is not None else None
            got = step(frames[i], flow, ext_flow)

            if ext_flow is not None:
                combined = self._compose_6_grid(
                    frames[i], got["ext_viz"], got["taa_frame"], got["taa_simple_frame"],
                    got["taa_ext_frame"], create_difference_overlay(flow, ext_flow),
                    width, height,
                )
            else:
                combined = self.composer.create_side_by_side(
                    frames[i],
                    got["flow_viz"],
                    flow_only=c.flow_only,
                    taa_frame=got.get("taa_frame"),
                    taa_simple_frame=got.get("taa_simple_frame"),
                    model_name=self.model_label,
                    fast_mode=c.fast,
                    flow_format=c.flow_format,
                )
            out.write(combined)
            if pbar:
                pbar.update(1)
        if pbar:
            pbar.close()

    def _compose_6_grid(
        self, original, flow_viz, taa_frame, taa_simple, taa_ext, diff, w, h
    ):
        """2x3 comparison grid (flow_processor.py:1218-1269)."""
        def to_bgr(x):
            return cv2.cvtColor(np.clip(x, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR)

        combined = np.zeros((h * 3, w * 2, 3), dtype=np.uint8)
        combined[0:h, 0:w] = to_bgr(original)
        combined[0:h, w:] = to_bgr(flow_viz)
        combined[h : 2 * h, 0:w] = to_bgr(taa_frame)
        combined[h : 2 * h, w:] = to_bgr(taa_simple)
        combined[2 * h :, 0:w] = to_bgr(taa_ext)
        combined[2 * h :, w:] = to_bgr(diff)

        labels = [
            ("Original", (10, 10)),
            ("External Flow", (w + 10, 10)),
            ("TAA + Original Flow", (10, h + 10)),
            ("TAA Simple", (w + 10, h + 10)),
            ("TAA + External Flow", (10, 2 * h + 10)),
            ("Flow Difference", (w + 10, 2 * h + 10)),
        ]
        for text, pos in labels:
            combined = self.composer.add_text_overlay(combined, text, pos)
        return combined

    @staticmethod
    def auto_play_video(video_path: str) -> None:
        """Open with the system player (flow_processor.py:1175-1212)."""
        import platform
        import subprocess

        if not os.path.exists(video_path):
            print(f"Video file not found for auto-play: {video_path}")
            return
        system = platform.system().lower()
        try:
            if system == "windows":
                subprocess.run(["cmd", "/c", "start", "", video_path], check=False)
            elif system == "darwin":
                subprocess.run(["open", video_path], check=False)
            elif system == "linux":
                subprocess.run(["xdg-open", video_path], check=False)
            else:
                print(f"Unknown operating system '{system}' - cannot auto-play video")
        except Exception as e:  # pragma: no cover
            print(f"Error launching video player: {e}")
