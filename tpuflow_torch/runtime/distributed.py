"""Multi-process execution on torch.distributed (port of
tpuflow/runtime/distributed.py).

- `init_distributed` starts the process group: arguments first, then the
  variables torchrun sets (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK,
  LOCAL_RANK, LOCAL_WORLD_SIZE), where the JAX package reads its own
  JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID.  Each rank
  takes `cuda:{local id}` (the local id modulo the cards: with one card
  every rank shares it) and the NCCL backend when every rank of the host
  owns a card, gloo when ranks share one or run on the CPU (NCCL refuses two
  ranks on one device).
- `host_frame_range` / `host_window_range`: each process's contiguous frame
  slice of the video (host-local decode), and the window context it needs.
- `gather_host_results`: the completion count, one scalar all-reduce over a
  gloo group (the default group when it is gloo), so it works in every
  layout; flows never cross processes, each writes its own cache slice.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device: str = "cuda",
) -> bool:
    """Start torch.distributed for this process; returns True if
    multi-process mode is active (a single process is a no-op).

    `coordinator_address` 'host:port' (rank 0 listens there), else
    MASTER_ADDR:MASTER_PORT; `num_processes` else WORLD_SIZE (default 1);
    `process_id` else RANK; `local_device_ids` (the first is this rank's
    card) else LOCAL_RANK, else the rank.  `device` 'cpu' keeps the rank on
    the CPU (gloo).  The rank's card becomes the current CUDA device, so
    'cuda' means it afterwards."""
    num_processes = num_processes if num_processes is not None else (_env_int("WORLD_SIZE") or 1)
    if num_processes <= 1:
        if coordinator_address is not None or process_id not in (None, 0):
            # A coordinator or rank without a process count means a
            # mis-launched job: running as one process would have every
            # process compute the whole video and race on the cache.
            raise ValueError(
                "init_distributed: coordinator_address/process_id given "
                f"but num_processes={num_processes}: set num_processes "
                "(or WORLD_SIZE) to the number of processes"
            )
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if coordinator_address is None:
        raise ValueError("init_distributed: no coordinator address (argument, or MASTER_ADDR and MASTER_PORT)")
    pid = process_id if process_id is not None else _env_int("RANK")
    if pid is None:
        raise ValueError("init_distributed: no process id (argument, or RANK)")
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("init_distributed: no CUDA device is visible; pass device='cpu'")
        local = local_device_ids[0] if local_device_ids else _env_int("LOCAL_RANK")
        local = pid if local is None else local
        torch.cuda.set_device(local % cards)
        local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
        if local_world <= cards and dist.is_nccl_available():
            backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=pid)
    return True


def rank() -> int:
    """This process's rank (0 when torch.distributed is not initialized)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 when torch.distributed is not initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_frame_range(
    total_frames: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """This process's contiguous [lo, hi) slice of the video's frames.

    Remainder frames go to the leading processes (sizes differ by at most
    one); every frame belongs to exactly one process.
    """
    p = rank() if process_index is None else process_index
    n = world_size() if process_count is None else process_count
    if not 0 <= p < n:
        raise ValueError(f"process_index {p} out of range for {n} processes")
    base, rem = divmod(total_frames, n)
    lo = p * base + min(p, rem)
    hi = lo + base + (1 if p < rem else 0)
    return lo, hi


def host_window_range(
    total_frames: int,
    sequence_length: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    context: Optional[Tuple[int, int]] = None,
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((decode_lo, decode_hi), (out_lo, out_hi)) for stride-1 window
    inference: the process owns output flows [out_lo, out_hi) and decodes
    the surrounding context too.  `context` overrides the (left, right)
    context frame counts (default seq//2 each side); MemFlow passes a
    larger left context, its memory warm-up prefix."""
    out_lo, out_hi = host_frame_range(total_frames, process_index, process_count)
    half = sequence_length // 2
    left, right = context if context is not None else (half, half)
    dec_lo = max(0, out_lo - left)
    dec_hi = min(total_frames, out_hi + right)
    return (dec_lo, dec_hi), (out_lo, out_hi)


def gather_host_results(local_done: int) -> int:
    """Total completed frames across processes (one scalar all-reduce over
    a gloo group, made for the call when the default group is NCCL;
    `local_done` itself without torch.distributed)."""
    if not dist.is_initialized():
        return local_done
    group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    total = torch.tensor([local_done], dtype=torch.int64)
    dist.all_reduce(total, group=group)
    return int(total.item())
