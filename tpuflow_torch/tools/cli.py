"""Flag-compatible CLI (the JAX package's tools/cli.py: the reference's
flow_processor.py argparse surface, flow_processor.py:1271-1332, with every
flag, default and choice) plus the JAX package's extensions under
`--allow-random-init`, `--batch-frames`, `--tile-overlap`,
`--data-parallel`, `--encoder`, `--stride-mode` and the multi-host flags,
and the port's own `--trace-dir` (the flow pass traced: its spans, counters
and kernels, runtime/profiling.trace_to).

    python3 -m tpuflow_torch.tools.cli --input clip.mp4 --allow-random-init

runs on the card; `--device cpu` runs the engine and the ops on the CPU.
`--interactive` computes the flows if the cache is incomplete and opens the
flow visualizer (tools/visualizer.py) on the same device.
`--num-processes N --coordinator HOST:PORT --process-id i` runs this
process's share of the flow pass on torch.distributed
(runtime/distributed.py) and writes its slice of the flow cache.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Optical Flow Processor (VideoFlow/MemFlow, PyTorch + CUDA)")
    p.add_argument("--input", default="big_buck_bunny_720p_h264.mov", help="Input video file")
    p.add_argument("--output", default="results", help="Output video file or directory (default: results)")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu", "tpu"], help="Processing device")
    p.add_argument("--frames", type=int, default=1000, help="Maximum number of frames to process (default: 1000)")
    p.add_argument("--start-frame", type=int, default=0, help="Starting frame number (0-based, default: 0)")
    p.add_argument("--start-time", type=float, default=None, help="Starting time in seconds (overrides --start-frame)")
    p.add_argument("--duration", type=float, default=None, help="Duration in seconds (overrides --frames)")
    p.add_argument("--fast", action="store_true", help="Enable fast mode (lower resolution, fewer iterations)")
    p.add_argument("--flow-only", action="store_true", help="Output only optical flow visualization (no original video)")
    p.add_argument("--taa", action="store_true", help="Add TAA effect visualization using previous-frame optical flow")
    p.add_argument("--flow-input", type=str, default=None, help="Input video with encoded motion vectors in bottom half")
    p.add_argument(
        "--flow-format",
        choices=["gamedev", "hsv", "torchvision", "motion-vectors-rg8", "motion-vectors-rgb8"],
        default="gamedev",
        help="Optical flow encoding format",
    )
    p.add_argument("--motion-vectors-clamp-range", type=float, default=32.0, help="Clamp range for motion-vectors formats (default: 32.0)")
    p.add_argument("--tile", action="store_true", help="Enable tile-based processing (1280x1280 square tiles)")
    p.add_argument("--sequence-length", type=int, default=5, help="Frames per inference window (default: 5, recommended: 5-9)")
    p.add_argument("--save-flow", choices=["flo", "npz", "both"], default=None, help="Save raw optical flow data")
    p.add_argument("--force-recompute", action="store_true", help="Force recomputation even if cached data exists")
    p.add_argument("--use-flow-cache", type=str, default=None, help="Use optical flow from specific cache directory")
    p.add_argument("--interactive", action="store_true", help="Launch interactive flow visualizer")
    p.add_argument("--show-tiles", action="store_true", help="Only show tile grid calculation without processing")
    p.add_argument("--no-autoplay", action="store_true", help="Disable automatic video playback after processing")
    p.add_argument("--skip-lods", action="store_true", help="Skip LOD pyramid generation/loading")
    p.add_argument("--uncompressed", action="store_true", help="Save the output video uncompressed (.avi)")
    p.add_argument("--model", choices=["videoflow", "memflow"], default="videoflow", help="Optical flow model")
    p.add_argument("--model-path", type=str, default=None, help="Custom path to model weights")
    p.add_argument("--stage", choices=["sintel", "things", "kitti"], default="sintel", help="Training stage/dataset (MemFlow)")
    p.add_argument("--vf-dataset", choices=["sintel", "things", "kitti"], default="sintel", help="Dataset for VideoFlow model")
    p.add_argument("--vf-architecture", choices=["mof", "bof"], default="mof", help="VideoFlow architecture")
    p.add_argument("--vf-variant", choices=["standard", "noise"], default="standard", help="VideoFlow model variant")
    # Extensions of the reference CLI, as in the JAX package
    p.add_argument(
        "--allow-random-init", action="store_true",
        help="[ext] run without a checkpoint on random weights (flows are "
             "meaningless; for smoke tests and throughput work only)",
    )
    p.add_argument("--batch-frames", type=int, default=4, help="[ext] windows batched per device step")
    p.add_argument("--tile-overlap", type=int, default=0, help="[ext] tile halo overlap in pixels (0 = reference hard paste)")
    p.add_argument("--data-parallel", type=int, default=1, help="[ext] devices to shard the frame batch over")
    p.add_argument(
        "--encoder",
        choices=["cnn", "twins"],
        default="twins",
        help="[ext] feature encoder backbone (twins = upstream checkpoint parity; "
        "cnn = RAFT BasicEncoder, lighter but not weight-compatible)",
    )
    p.add_argument(
        "--stride-mode", choices=["center", "interior"], default="center",
        help="[ext] 'center' = reference parity (one middle-frame flow per window); "
             "'interior' = keep all interior-frame flows ((T-2)x throughput)",
    )
    # Multi-process flow pass (torch.distributed; runtime/distributed.py).
    p.add_argument("--coordinator", type=str, default=None,
                   help="[ext] multi-host coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=1,
                   help="[ext] total processes in the multi-host run")
    p.add_argument("--process-id", type=int, default=None,
                   help="[ext] this process's id (0..num-processes-1)")
    p.add_argument(
        "--trace-dir", type=str, default=None,
        help="[ext] run the flow pass with the program's spans on, under torch.profiler: "
             "writes a Chrome trace and spans.json (per span calls, host and device seconds, "
             "counters, per-frame figures) to this directory and prints the span table",
    )
    return p


def args_to_config(args: argparse.Namespace) -> PipelineConfig:
    return PipelineConfig(
        input=args.input,
        output=args.output,
        device=args.device,
        frames=args.frames,
        start_frame=args.start_frame,
        start_time=args.start_time,
        duration=args.duration,
        fast=args.fast,
        flow_only=args.flow_only,
        taa=args.taa,
        flow_input=args.flow_input,
        flow_format=args.flow_format,
        motion_vectors_clamp_range=args.motion_vectors_clamp_range,
        tile=args.tile,
        sequence_length=args.sequence_length,
        save_flow=args.save_flow,
        force_recompute=args.force_recompute,
        use_flow_cache=args.use_flow_cache,
        interactive=args.interactive,
        show_tiles=args.show_tiles,
        no_autoplay=args.no_autoplay,
        skip_lods=args.skip_lods,
        uncompressed=args.uncompressed,
        model=args.model,
        model_path=args.model_path,
        stage=args.stage,
        vf_dataset=args.vf_dataset,
        vf_architecture=args.vf_architecture,
        vf_variant=args.vf_variant,
        encoder=args.encoder,
        allow_random_init=args.allow_random_init,
        batch_frames=args.batch_frames,
        tile_overlap=args.tile_overlap,
        data_parallel=args.data_parallel,
        stride_mode=args.stride_mode,
    )


def show_tiles_report(config: PipelineConfig) -> None:
    """Tile-grid analyzer (flow_processor.py:1531-1597)."""
    from ..pipeline.video_io import VideoInfo, fast_mode_dimensions
    from ..runtime.tiles import calculate_tile_grid, resolve_tile_layout

    info = VideoInfo(config.input).get_info()
    w, h = info["width"], info["height"]
    if config.fast:
        w, h, _ = fast_mode_dimensions(w, h)
    # The engine's own layout resolution, so the report shows the grid the
    # run executes (balanced by default; TPUFLOW_TILE_LAYOUT=reference for
    # the reference geometry).
    layout = resolve_tile_layout()
    tw, th, cols, rows, tiles = calculate_tile_grid(w, h, layout=layout)
    print(f"Video: {config.input} ({w}x{h}{' fast-mode' if config.fast else ''})")
    print(f"Tile grid ({layout}): {cols}x{rows} = {len(tiles)} tiles of {tw}x{th}")
    for i, t in enumerate(tiles):
        print(
            f"  tile {i}: pos=({t['x']},{t['y']}) size={t['width']}x{t['height']}"
            f" (row {t['row']}, col {t['col']})"
        )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = args_to_config(args)

    if not os.path.exists(config.input):
        print(f"Error: Input video not found: {config.input}")
        return 1

    if config.show_tiles:
        show_tiles_report(config)
        return 0

    if config.interactive:
        from .visualizer import launch_interactive

        return launch_interactive(config)

    if args.num_processes > 1:
        # Multi-process flow pass: compute this process's cache slice and
        # stop.  Rendering is a one-process step over the completed cache
        # (re-run without the multi-process flags).  --device cpu keeps every
        # rank on the CPU (gloo); on the card each rank takes its own card,
        # or shares the one there is (gloo, as NCCL refuses that).
        import torch.distributed as dist

        from ..runtime.distributed import init_distributed
        from .pipeline import FlowPipeline

        init_distributed(args.coordinator, args.num_processes, args.process_id,
                         device="cpu" if config.device == "cpu" else "cuda")
        try:
            cache_dir = FlowPipeline(config, trace_dir=args.trace_dir).compute_flows_distributed()
        finally:
            dist.destroy_process_group()
        print(f"Flow cache complete: {cache_dir}")
        return 0

    from .pipeline import FlowPipeline

    pipeline = FlowPipeline(config, trace_dir=args.trace_dir)
    pipeline.process_video()
    return 0


if __name__ == "__main__":
    sys.exit(main())
