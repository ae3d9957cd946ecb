#!/usr/bin/env python3
"""Data parallelism and torch.distributed of the port (tpuflow_torch) across
the cards of one host.

    python3 chip_multicard.py              # every visible card (at least 2)
    python3 chip_multicard.py --cards 2    # a mesh of two slots; on a
                                           # one-card machine both are cuda:0
    python3 chip_multicard.py --phases spatial   # only the phases named

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line); product configuration (Twins, 4 levels, radius 4,
12 iterations, T=5, bf16, seeded random weights), TF32 off:

1. mesh: FlowEngine(mesh=) over the n slots (cuda:i, or cuda:0 repeated on
   one card) on 2n synthetic 1920x1080 frames: compute_flows_tiled_stride1
   with window_batch n (one window per slot and batch) bit for bit the
   one-card engine's window_batch 1 on cuda:0, and compute_flow_batch of n
   untiled windows (one per slot) bit for bit the one-card engine's
   compute_flow of each; frames/s of both, host clock, every card
   synchronized.
2. train: n processes of this script (--train-rank), one per slot,
   torch.distributed by runtime/distributed.init_distributed (NCCL when
   each has a card, gloo when they share one), each one SGD step of
   shard_train_step on its own window of a seeded batch (the narrow
   configuration of chip_smoke's train phase, f32): their gradients are
   averaged over the world.  Against this process's shard_train_step over
   the n-slot mesh on all n windows: the loss and every gradient within
   chip_smoke's TRAIN_LOSS_TOL and TRAIN_GRAD_SHARE.
3. flow pass: n processes of `python3 -m tpuflow_torch.tools.cli
   --num-processes n --tile` on a 1920x1080 clip of 2n frames, one per
   slot; the union cache bit for bit one process's compute_flows_distributed
   on a copy of the clip; each process's wall.
4. spatial: runtime/sharding.shard_spatial_forward over ('data' 1,
   'spatial' n), one strip of the frame's height per slot (34, 34, 34, 33
   of 135 feature rows on four), on one untiled 1920x1080 window (T = 5,
   'auto': FlashCorr2 decided on the whole grid), against one card's
   compute_flow of the same window within chip_smoke's FLOW_MEAN_LIMIT /
   FLOW_MAX_LIMIT; the wall of both (host clock, every card synchronized,
   after a warm-up), each card's peak memory during the sharded call, and
   the bytes the strips took from each other (all across cards when each
   strip has a card of its own).

Output: progress lines, the card's name and power limit, the device count,
and last one JSON line of the results.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

TRAIN_ARG = "--train-rank"
TIMEOUT = 900


def slot_devices(n: int) -> list:
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def synchronize_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    synchronize_all()
    t0 = time.perf_counter()
    out = fn()
    synchronize_all()
    return out, time.perf_counter() - t0


def phase_mesh(n: int) -> dict:
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine
    from tpuflow_torch.runtime.sharding import Mesh

    one = FlowEngine(ModelConfig(), seed=cs.SEED, device=slot_devices(1)[0])
    one.load_model(allow_random_init=True)
    mesh = FlowEngine(ModelConfig(), seed=cs.SEED, params=one.model.state_dict(), mesh=Mesh(slot_devices(n)))
    mesh.load_model()
    frames = cs.synthetic_clip(2 * n, cs.MAIN_H, cs.MAIN_W, cs.SEED)
    one.compute_flows_tiled_stride1(frames[:5])                      # warm-up
    mesh.compute_flows_tiled_stride1(frames[:5], window_batch=n)
    ref, ref_wall = timed(lambda: one.compute_flows_tiled_stride1(frames))
    got, wall = timed(lambda: mesh.compute_flows_tiled_stride1(frames, window_batch=n))
    if not np.array_equal(got, ref):
        raise AssertionError(f"mesh tiled: not bit for bit one card's (max |diff| {np.abs(got - ref).max()})")
    idx = list(range(n))
    singles = np.stack([one.compute_flow(frames, i) for i in idx])
    batch, batch_wall = timed(lambda: mesh.compute_flow_batch(frames, idx))
    if not np.array_equal(batch, singles):
        raise AssertionError(f"mesh untiled: not bit for bit one card's (max |diff| {np.abs(batch - singles).max()})")
    out = {"frames": 2 * n, "one_card_frames_per_s": 2 * n / ref_wall, "mesh_frames_per_s": 2 * n / wall,
           "speedup": ref_wall / wall, "untiled_windows": n, "untiled_wall_s": batch_wall,
           "memory_usage": mesh.get_memory_usage()}
    cs.log(f"mesh over {n} slots {[str(d) for d in slot_devices(n)]}: tiled {2 * n} frames of 1920x1080 "
           f"{out['mesh_frames_per_s']:.4f} frames/s against one card's {out['one_card_frames_per_s']:.4f} "
           f"(x{out['speedup']:.3f}), bit for bit; {n} untiled windows in {batch_wall:.3f} s, bit for bit")
    del one, mesh
    torch.cuda.empty_cache()
    return out


def phase_spatial(n: int) -> dict:
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine
    from tpuflow_torch.runtime.sharding import Mesh, shard_spatial_forward

    one = FlowEngine(ModelConfig(), seed=cs.SEED, device=slot_devices(1)[0])
    one.load_model(allow_random_init=True)
    t = one.config.sequence_length
    frames = cs.synthetic_clip(t, cs.MAIN_H, cs.MAIN_W, cs.SEED + 5)
    one.compute_flow(frames, t // 2)                                  # warm-up
    ref, ref_wall = timed(lambda: one.compute_flow(frames, t // 2))
    sharded = shard_spatial_forward(one.model, Mesh([slot_devices(n)], ("data", "spatial")), 5, 2)
    params = one.model.state_dict()
    x = torch.from_numpy(frames[None]).to(one.device).float() / 255.0
    with torch.inference_mode():
        sharded(params, x)                                            # warm-up
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
        (fwd, _), wall = timed(lambda: sharded(params, x))
    peaks = {f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 2**30 for i in range(torch.cuda.device_count())}
    flow = fwd[0, fwd.shape[1] // 2].float().cpu().numpy()
    agree = cs.check_flows_agree(f"spatial over {n} slots vs one card's compute_flow", flow, ref)
    fetched = sum(sharded.groups[0].fetched_bytes)
    out = {"slots": n, "strip_rows": sharded.groups[0].rows, "wall_s": wall, "one_card_wall_s": ref_wall,
           "speedup": ref_wall / wall, "peak_gib": peaks, "bytes_between_strips": fetched, **agree}
    cs.log(f"spatial over {n} slots {[str(d) for d in slot_devices(n)]}: one 1920x1080 window in {wall:.3f} s "
           f"against one card's {ref_wall:.3f} s (x{ref_wall / wall:.3f}), strips {out['strip_rows']}, peak GiB "
           f"{ {k: round(v, 2) for k, v in peaks.items()} }, {fetched / 1e6:.1f} MB between strips")
    del one, sharded
    torch.cuda.empty_cache()
    return out


def narrow_model(dev):
    from tpuflow_torch.core.mofnet import MOFNet
    from tpuflow_torch.runtime.engine import init_random_

    model = MOFNet(corr_dtype=torch.float32, dense_lookup="xla", gma_impl="xla", **cs.TRAIN_NARROW)
    init_random_(model, cs.SEED + 60)
    return model.to(dev)


def narrow_batch(n: int):
    h, w = cs.TRAIN_NARROW_HW
    return cs.train_batch(torch.device("cpu"), n, 3, h, w, cs.SEED + 61)


def train_rank(rank: int, n: int, coord: str, out_dir: str) -> int:
    """One process of phase 2 (this script with TRAIN_ARG)."""
    import torch.distributed as dist

    from tpuflow_torch.runtime.distributed import init_distributed
    from tpuflow_torch.runtime.sharding import Mesh, make_train_step, shard_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(coord, n, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    model = narrow_model(dev)
    windows, targets = narrow_batch(n)
    step = shard_train_step(make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0)), Mesh([dev]))
    loss = step(windows[rank : rank + 1], targets[rank : rank + 1]).item()
    torch.save({"loss": loss, "backend": dist.get_backend(), "device": str(dev),
                "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()}},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def run_together(cmds) -> list:
    """Start the commands at once; (output, wall s) of each within TIMEOUT."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = [(subprocess.Popen(c, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
              time.perf_counter()) for c in cmds]
    results = []
    try:
        for proc, t0 in procs:
            results.append((proc.communicate(timeout=TIMEOUT)[0], time.perf_counter() - t0))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for (proc, _), (text, _) in zip(procs, results):
        if proc.returncode != 0:
            raise AssertionError(f"a process failed:\n{text[-3000:]}")
    return results


def phase_train(n: int) -> dict:
    from tpuflow_torch.runtime.sharding import Mesh, make_train_step, shard_train_step

    with tempfile.TemporaryDirectory() as tmp:
        coord = f"127.0.0.1:{cs.free_port()}"
        results = run_together([[sys.executable, __file__, TRAIN_ARG, str(r), str(n), coord, tmp] for r in range(n)])
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n)]
    model = narrow_model(slot_devices(1)[0])
    step = shard_train_step(make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0)),
                            Mesh(slot_devices(n)))
    loss = step(*narrow_batch(n)).item()
    ref = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    worst = 0.0
    for r, got in enumerate(ranks):
        rel = abs(got["loss"] - loss) / abs(loss)
        bad = [k for k, g in ref.items()
               if (got["grads"][k] - g).abs().max() > cs.TRAIN_GRAD_SHARE * g.abs().max() + 1e-6]
        worst = max([worst] + [((got["grads"][k] - g).abs().max() / (g.abs().max() + 1e-6)).item()
                               for k, g in ref.items()])
        if rel > cs.TRAIN_LOSS_TOL or bad:
            raise AssertionError(f"train rank {r}: loss relative {rel}, gradients off in {bad[:5]}")
    out = {"ranks": n, "backends": sorted({g["backend"] for g in ranks}), "devices": [g["device"] for g in ranks],
           "loss": loss, "worst_grad_share": worst, "process_wall_s": [t for _, t in results]}
    cs.log(f"train over {n} processes ({out['backends']}, {out['devices']}): world-averaged gradients against one "
           f"process's {n}-slot mesh, loss {loss}, worst gradient share {worst:.3e} "
           f"(limit {cs.TRAIN_GRAD_SHARE:g}); walls {[round(t, 3) for _, t in results]} s")
    return out


def phase_flow_pass(n: int) -> dict:
    from tpuflow_torch.config import PipelineConfig
    from tpuflow_torch.tools.pipeline import FlowPipeline

    frames = 2 * n
    with tempfile.TemporaryDirectory() as tmp:
        video, single = os.path.join(tmp, "clip.avi"), os.path.join(tmp, "single.avi")
        cs.write_clip(video, frames, cs.MAIN_H, cs.MAIN_W, cs.SEED + 62)
        shutil.copy(video, single)
        coord = f"127.0.0.1:{cs.free_port()}"
        results = run_together([[sys.executable, "-m", "tpuflow_torch.tools.cli", "--input", video, "--frames",
                                 str(frames), "--output", tmp, "--allow-random-init", "--skip-lods", "--no-autoplay",
                                 "--tile", "--coordinator", coord, "--num-processes", str(n), "--process-id", str(r)]
                                for r in range(n)])
        pipe = FlowPipeline(PipelineConfig(input=single, frames=frames, tile=True, allow_random_init=True,
                                           skip_lods=True))
        _, one_wall = timed(pipe.compute_flows_distributed)
        dist, ref = cs.cached_flows(pipe, video, frames), cs.cached_flows(pipe, single, frames)
    if not np.array_equal(dist, ref):
        raise AssertionError(f"flow pass over {n} processes: not bit for bit one process's "
                             f"(max |diff| {np.abs(dist - ref).max()})")
    owned = [line.split("own flows ")[1] for text, _ in results for line in text.splitlines() if "own flows" in line]
    out = {"processes": n, "frames": frames, "owned": owned, "process_wall_s": [t for _, t in results],
           "one_process_wall_s": one_wall}
    cs.log(f"flow pass over {n} processes --tile, {frames} frames of 1920x1080: owned {owned}, walls "
           f"{[round(t, 3) for _, t in results]} s, one process {one_wall:.3f} s, bit for bit")
    return out


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == [TRAIN_ARG]:
        return train_rank(int(args[1]), int(args[2]), args[3], args[4])
    smi = cs.phase_environment()
    opts = dict(zip(args[::2], args[1::2]))
    if len(args) % 2 or set(opts) - {"--cards", "--phases"}:
        raise SystemExit("usage: python3 chip_multicard.py [--cards N] [--phases mesh,train,flow_pass,spatial]")
    n = int(opts.get("--cards", torch.cuda.device_count()))
    if n < 2:
        raise SystemExit("chip_multicard: needs at least 2 slots (--cards 2 repeats the one card)")
    phases = {"mesh": phase_mesh, "train": phase_train, "flow_pass": phase_flow_pass, "spatial": phase_spatial}
    names = opts.get("--phases", ",".join(phases)).split(",")
    if set(names) - set(phases):
        raise SystemExit(f"chip_multicard: unknown phases {set(names) - set(phases)}")
    cs.phase_build()
    out = {"slots": n, "devices": [str(d) for d in slot_devices(n)]}
    for name in names:
        out[name] = phases[name](n)
    print(smi)
    print("device count", torch.cuda.device_count())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
