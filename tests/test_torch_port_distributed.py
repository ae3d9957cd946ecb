"""The port's multi-process execution (tpuflow_torch.runtime.distributed, the
pipeline's compute_flows_distributed and the CLI's --num-processes) on the
CPU, against the JAX package's range functions and the port's own
one-process runs.

Every multi-process case spawns real processes on gloo, each with a free
port of its own and a timeout of its own.  Tolerances: the ranges and the
completion count exactly; the averaged step of two processes against one
process with both windows on a two-slot mesh within 1e-6 (parameters) and
1e-5 of each gradient's largest entry plus 1e-7; the two-process CLI cache
within 1e-5 of the largest |flow| of the one-process cache (the processes'
batches hold other windows, which the CPU sums in another order; a window
that a slice clips at its start would be off by a frame's motion); MemFlow's
streams bit for bit (each process's warm-up prefix reaches frame 0).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow.runtime import distributed as jdist
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

from tpuflow_torch.pipeline.cache import FlowCacheManager
from tpuflow_torch.pipeline.filenames import generate_cache_directory
from tpuflow_torch.runtime import distributed as tdist

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 420


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return env


def _run_all(cmds, cwd=REPO):
    """Start every command at once, wait for each within TIMEOUT, and return
    their outputs; a failed or late process fails the test."""
    procs = [subprocess.Popen(c, cwd=cwd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


# ---------------------------------------------------------------------------
# ranges and the mis-launch error
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("total", [0, 1, 3, 10, 11, 100])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_ranges_match_jax(total, n):
    """host_frame_range and host_window_range (the default context, and
    MemFlow's warm-up context) equal the JAX package's for every process."""
    for p in range(n):
        assert tdist.host_frame_range(total, p, n) == jdist.host_frame_range(total, p, n)
        for seq, ctx in ((5, None), (3, None), (5, (16, 2))):
            assert tdist.host_window_range(total, seq, p, n, ctx) == jdist.host_window_range(total, seq, p, n, ctx)
    with pytest.raises(ValueError):
        tdist.host_frame_range(total, n, n)


def test_ranges_default_to_one_process():
    assert tdist.host_frame_range(10) == (0, 10) == jdist.host_frame_range(10)
    assert tdist.gather_host_results(7) == 7


@pytest.mark.parametrize("kw", [dict(coordinator_address="127.0.0.1:1"), dict(process_id=1),
                                dict(coordinator_address="127.0.0.1:1", num_processes=1)])
def test_mislaunch_raises_as_in_jax(kw, monkeypatch):
    """A coordinator or a rank without a process count raises ValueError in
    both packages, before any runtime starts; one process is a no-op."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        tdist.init_distributed(**kw)
    with pytest.raises(ValueError, match="num_processes"):
        jdist.init_distributed(**kw)
    assert tdist.init_distributed() is False and jdist.init_distributed() is False
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        tdist.init_distributed(num_processes=2, process_id=0, device="cpu")


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------
def test_two_process_gloo_world(tmp_path):
    """Two spawned processes: their ranges, the all-reduced completion count,
    and one shard_train_step each on its own window whose gradients are
    averaged over the world: equal to one process stepping both windows
    over a two-slot mesh."""
    from tpuflow_torch.core.mofnet import MOFNet
    from tpuflow_torch.runtime.engine import init_random_
    from tpuflow_torch.runtime.sharding import Mesh, make_train_step, shard_train_step

    coord = f"127.0.0.1:{_free_port()}"
    _run_all([[sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"), coord, "2", str(pid), "10",
               "5", str(tmp_path)] for pid in range(2)])
    results = [json.loads((tmp_path / f"worker{pid}.json").read_text()) for pid in range(2)]
    assert [r["out"] for r in results] == [[0, 5], [5, 10]]
    assert [r["decode"] for r in results] == [[0, 7], [3, 10]]
    assert all(r["total_done"] == 10 for r in results)

    model = MOFNet(corr_dtype=torch.float32, dense_lookup="xla", gma_impl="xla", encoder="cnn", corr_levels=2,
                   corr_radius=2, decoder_depth=2, feature_dim=64)
    init_random_(model, 7)
    rng = np.random.default_rng(11)
    windows = torch.from_numpy(rng.random((2, 3, 32, 32, 3), dtype=np.float32))
    targets = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 2)).astype(np.float32))
    step = shard_train_step(make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2)),
                            Mesh(["cpu", "cpu"]))
    loss = step(windows, targets).item()
    workers = [torch.load(tmp_path / f"worker{pid}.pt") for pid in range(2)]
    assert results[0]["loss"] == pytest.approx(loss, rel=1e-6) and results[1]["loss"] == results[0]["loss"]
    for k, p in model.named_parameters():
        for w in workers:
            g = p.grad
            assert (w["grads"][k] - g).abs().max() <= 1e-5 * g.abs().max() + 1e-7, k
            torch.testing.assert_close(w["params"][k], p.detach(), rtol=0, atol=1e-6)


def write_clip(path: str, n: int, shift: int, seed: int) -> str:
    """A moving random texture (tests/test_distributed.py), MJPG."""
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (96, 64))
    base = np.random.default_rng(seed).integers(0, 255, (64, 96, 3), np.uint8)
    for i in range(n):
        out.write(np.roll(base, i * shift, axis=1))
    out.release()
    return path


def cli(video: str, out_dir: str, n: int, extra) -> list:
    return [sys.executable, "-m", "tpuflow_torch.tools.cli", "--input", video, "--frames", str(n),
            "--output", out_dir, "--allow-random-init", "--device", "cpu", "--skip-lods", "--no-autoplay", *extra]


def load_cache(video: str, n: int, **kw) -> np.ndarray:
    args = dict(start_frame=0, max_frames=n, sequence_length=5, fast_mode=False, tile_mode=False,
                model="videoflow", dataset="sintel", architecture="mof", variant="standard")
    args.update(kw)
    cache = generate_cache_directory(video, **args)
    mgr = FlowCacheManager()
    ok, fmt, missing = mgr.check_cache_exists(cache, n)
    assert ok, (cache, fmt, missing)
    return np.stack([mgr.load_cached_flow(cache, i, fmt) for i in range(n)])


@pytest.mark.parametrize("procs,n", [(2, 6), (4, 8)])
def test_multi_process_cli_flow_pass(tmp_path, procs, n):
    """`--num-processes` CLI processes (gloo on the CPU) each compute and
    write their own range of the clip; the union cache equals the
    one-process CLI's cache (tests/test_torch_port_cli.py holds that route to
    the JAX package).  8 frames over 4 processes leave the last one two
    frames at the clip's end, whose windows the decoded slice must not clip
    at its own start (test_slices_keep_every_window)."""
    video = write_clip(str(tmp_path / "clip.avi"), n + 2, 2, 0)
    single = str(tmp_path / "single.avi")
    shutil.copy(video, single)                       # same frames, its own cache directory
    os.makedirs(tmp_path / "out")
    coord = f"127.0.0.1:{_free_port()}"
    common = ["--encoder", "cnn", "--fast"]
    logs = _run_all([cli(video, str(tmp_path / "out"), n, common + ["--coordinator", coord, "--num-processes",
                                                                   str(procs), "--process-id", str(pid)])
                     for pid in range(procs)] + [cli(single, str(tmp_path / "out"), n, common)])
    owned = [tdist.host_frame_range(n, pid, procs) for pid in range(procs)]
    assert all(f"own flows [{lo}, {hi})" in log for log, (lo, hi) in zip(logs, owned))
    assert all(f"{n}/{n} flows complete" in log for log in logs[:procs])
    dist = load_cache(video, n, fast_mode=True)
    ref = load_cache(single, n, fast_mode=True)
    assert np.isfinite(dist).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(dist, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seq", [3, 5, 7])
def test_slices_keep_every_window(seq):
    """Every owned frame's centred window, computed by the engine inside the
    slice that compute_flows_distributed decodes (one frame more on the left
    than the windows reach), is its window in the whole clip.  With the JAX
    package's (half, half) slice it is not at 8 frames over 4 processes:
    frame 6's window replicates its edge at the slice's start."""
    from tpuflow.runtime.windows import centered_window_indices as jax_window
    from tpuflow_torch.runtime.windows import centered_window_indices as window

    half = seq // 2
    for n in range(1, 24):
        for procs in range(1, 9):
            for pid in range(procs):
                (lo, hi), (olo, ohi) = tdist.host_window_range(n, seq, pid, procs, (half + 1, half))
                for i in range(olo, ohi):
                    assert list(window(hi - lo, i - lo, seq) + lo) == list(window(n, i, seq)), (n, procs, pid, i)
    (lo, hi), _ = jdist.host_window_range(8, 5, 3, 4)
    assert list(jax_window(hi - lo, 6 - lo, 5) + lo) == [4, 4, 5, 6, 7] != list(jax_window(8, 6, 5))


def test_two_process_memflow_memory_warmup(tmp_path):
    """MemFlow over two processes: each replays its memory warm-up prefix
    (2 x memory_capacity frames, which reaches frame 0 on this clip) before
    its first owned output, so the union cache equals the one-process
    stream bit for bit."""
    video = write_clip(str(tmp_path / "clip.avi"), 8, 3, 2)
    single = str(tmp_path / "single.avi")
    shutil.copy(video, single)
    os.makedirs(tmp_path / "out")
    n, coord = 8, f"127.0.0.1:{_free_port()}"
    common = ["--model", "memflow"]
    logs = _run_all([cli(video, str(tmp_path / "out"), n, common + ["--coordinator", coord, "--num-processes", "2",
                                                                   "--process-id", str(pid)]) for pid in range(2)]
                    + [cli(single, str(tmp_path / "out"), n, common)])
    assert "replaying 0 context frames" in logs[0] and "replaying 4 context frames" in logs[1]
    kw = dict(model="memflow", fast_mode=False)
    np.testing.assert_array_equal(load_cache(video, n, **kw), load_cache(single, n, **kw))
