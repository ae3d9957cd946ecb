"""Worker for tests/test_torch_port_distributed.py: one process of a
2-process gloo run of the port on the CPU.  Not a pytest module (no test_
prefix).

argv: coordinator_address num_processes process_id total_frames seq_len out_dir

Initializes torch.distributed through tpuflow_torch.runtime.distributed,
takes its frame ranges and the all-reduced completion count, then runs one
shard_train_step (SGD) on its own window of a seeded batch over a one-slot
mesh, and writes what it saw to out_dir/worker{pid}.json and its parameters
and gradients after the step to out_dir/worker{pid}.pt.
"""

import json
import os
import sys


def main():
    coord, nproc, pid, total, seq, out_dir = sys.argv[1:7]
    nproc, pid, total, seq = int(nproc), int(pid), int(total), int(seq)

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.modules["jax"] = None          # the port runs without JAX
    from tpuflow_torch.core.mofnet import MOFNet
    from tpuflow_torch.runtime.distributed import (
        gather_host_results,
        host_window_range,
        init_distributed,
    )
    from tpuflow_torch.runtime.engine import init_random_
    from tpuflow_torch.runtime.sharding import Mesh, make_train_step, shard_train_step

    active = init_distributed(coord, nproc, pid, device="cpu")
    assert active and dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    (dec_lo, dec_hi), (out_lo, out_hi) = host_window_range(total, seq)
    total_done = gather_host_results(out_hi - out_lo)

    model = MOFNet(corr_dtype=torch.float32, dense_lookup="xla", gma_impl="xla", encoder="cnn", corr_levels=2,
                   corr_radius=2, decoder_depth=2, feature_dim=64)
    init_random_(model, 7)
    rng = np.random.default_rng(11)
    windows = torch.from_numpy(rng.random((nproc, 3, 32, 32, 3), dtype=np.float32))
    targets = torch.from_numpy(rng.normal(0, 1, (nproc, 32, 32, 2)).astype(np.float32))
    step = shard_train_step(make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2)),
                            Mesh(["cpu"]))
    loss = step(windows[pid : pid + 1], targets[pid : pid + 1]).item()
    torch.save({"params": model.state_dict(), "grads": {k: p.grad for k, p in model.named_parameters()}},
               os.path.join(out_dir, f"worker{pid}.pt"))
    with open(os.path.join(out_dir, f"worker{pid}.json"), "w") as f:
        json.dump({"decode": [dec_lo, dec_hi], "out": [out_lo, out_hi], "total_done": total_done,
                   "loss": loss}, f)
    dist.destroy_process_group()
    print("worker", pid, "ok", flush=True)


if __name__ == "__main__":
    main()
