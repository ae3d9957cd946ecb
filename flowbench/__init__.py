"""flowbench: the benchmark of tpuflow_torch, the PyTorch and CUDA port.

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository's root names the cells and metrics; each
configuration, cell, traffic mix and per-layer metric is a file of its own
here, found by its name (spec.py)."""
