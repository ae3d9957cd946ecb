"""One run of one cell: set-up, the measured window, the traced call, the
check against the plain reference, and the result line.

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The route of the cell (routes/<route>.py) builds the program's side from the
configuration, makes the traffic, warms up the cell's own shapes, runs the
window, and after the window checks what the window delivered against the
reference.  Set-up is the time from the process's start to the end of the
warm-up.  The window opens at the start of the first call after the
warm-up and closes at the first completion at or after `--seconds`; the
rate is the frames completed in it over its length.  With `--trace 1` the
window's first call runs under torch.profiler (and the per-layer metrics'
hooks), and the per-layer metrics are read from it instead of the
end-to-end ones."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import spans
from . import spec as spec_mod
from . import trace as trace_mod
from .models import reference_model
from .weights import draw_state_dict

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuflow")


def log(*parts) -> None:
    print("[flowbench]", *parts, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole (tpuflow_torch is not tpuflow)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Window:
    """The measured window: `open()` at the first call's start, `done(k)` at
    each completion of k frames; closed by the first completion at or after
    `seconds`.  Completions after the close do not count."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.frames = 0

    def open(self) -> None:
        if self.t_open is None:
            self.t_open = time.perf_counter()

    @property
    def closed(self) -> bool:
        return self.t_close is not None

    def done(self, frames: int) -> bool:
        """Count a completion of `frames`; False once the window has closed."""
        if self.closed:
            return False
        now = time.perf_counter()
        self.frames += frames
        if now - self.t_open >= self.seconds:
            self.t_close = now
        return True

    def rate(self) -> float:
        return self.frames / (self.t_close - self.t_open)


class Tracer:
    """Runs the window's first call under torch.profiler with the program's
    spans on (they name the trace's idle gaps) and the per-layer metrics'
    hooks installed; a no-op in an untraced run."""

    def __init__(self, run: "Run", metrics: Dict[str, object]):
        self.run = run
        self.metrics = metrics
        self.result: Optional[trace_mod.Traced] = None

    def call(self, fn: Callable[[], int], index: int) -> int:
        """fn() -> frames delivered; traced when it is the first call."""
        if index != 0 or not self.metrics:
            t0 = time.perf_counter()
            frames = fn()
            log(f"call {index}: {frames} frames in {time.perf_counter() - t0:.3f} s")
            return frames
        from torch.profiler import ProfilerActivity, profile, record_function

        undo = [spans.install(self.run)]
        undo += [m.install(self.run) for m in self.metrics.values() if hasattr(m, "install")]
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("flowbench.traced_call"):
                    self.run.sync()
                    t0 = time.perf_counter()
                    frames = fn()
                    self.run.sync()
                    wall = time.perf_counter() - t0
        finally:
            for u in undo:
                if u is not None:
                    u()
        marks = [ev for ev in prof.events() if ev.name == "flowbench.traced_call"]
        rng = marks[0].time_range
        self.result = trace_mod.from_profiler(prof, frames, wall, float(rng.start), float(rng.end))
        return frames


class Run:
    """The state of one run, shared by its route and the metric readers
    (`route`: the cell's route, set once it is built)."""

    def __init__(self, cell_name: str, seed: int, seconds: float, traced: bool, device: str,
                 t0: float, spec: spec_mod.Spec, overrides: Optional[dict] = None):
        overrides = overrides or {}
        self.name, self.seed, self.seconds, self.traced = cell_name, seed, seconds, traced
        self.device = torch.device(device)
        self.t0 = t0
        self.spec = spec
        self.cell = {**spec.workload(cell_name), **overrides.get("cell", {})}
        self.config = spec.config(self.cell["config"])
        self.config = {**self.config, "model_config": {**self.config["model_config"], **overrides.get("model_config", {})},
                       "reference_args": {**self.config["reference_args"], **overrides.get("reference_args", {})}}
        self.traffic = {**spec.traffic(self.cell["traffic"]), **overrides.get("traffic", {})}
        self.engine = None
        self.route = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serving_dtype(self) -> torch.dtype:
        return getattr(torch, self.config["dtype"]) if self.device.type == "cuda" else torch.float32

    def draw_weights(self):
        """(the program's state dict on the device, the reference's f32 copy
        on the host)."""
        meta = reference_model(self.config, "meta")
        sd = draw_state_dict(meta, self.seed, self.device, self.serving_dtype())
        return sd, {k: v.float().cpu() for k, v in sd.items()}

    def reference(self, state: dict):
        """The plain reference in float32 on this run's device, loaded with
        `state` (strict)."""
        model = reference_model(self.config, self.device)
        model.load_state_dict(state, strict=True)
        return model

    def free_program(self) -> None:
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class NoTF32:
    """float32 products without TF32 inside the block (the reference's own
    computation); the flags as they were afterwards."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t0: Optional[float] = None, spec: Optional[spec_mod.Spec] = None,
             overrides: Optional[dict] = None, patch: Optional[Callable[["Run", object], None]] = None,
             keep: Optional[dict] = None) -> dict:
    """One run of `cell_name`; returns the result object.  `overrides` and
    `patch` (patch(run, route), called after set-up, before the warm-up:
    faults.py) exist for the tests and calibrate.py, which drive runs at
    small sizes or with the timed path broken; `keep` receives the route."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = spec or spec_mod.Spec()
    run = Run(cell_name, seed, seconds, traced, device, t0, spec, overrides)
    route = run.route = spec.route_module(run.cell["route"]).Route(run)
    if keep is not None:
        keep["route"] = route
    route.setup()
    if patch is not None:
        patch(run, route)
    route.warmup()
    run.sync()
    setup_s = time.perf_counter() - t0
    log(f"{cell_name} seed {seed}: set-up {setup_s:.3f} s")

    metrics = {}
    if traced:
        metrics = {m["name"]: spec.metric_module(m["name"]) for m in spec.per_layer(cell_name)}
    tracer = Tracer(run, metrics)
    window = Window(seconds)
    route.window(window, tracer)
    run.sync()
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    log(f"window {window.t_close - window.t_open:.3f} s, {window.frames} frames, peak {peak / 2**30:.3f} GiB")

    values: Dict[str, float] = {}
    if traced:
        tr = tracer.result
        for name, mod in metrics.items():
            v = mod.read(run, tr)
            if v is not None:
                values[name] = v
    else:
        e2e = {"setup_s": setup_s, "peak_mem_gib": peak / 2**30, route.RATE: window.rate()}
        for m in spec.end_to_end(cell_name):
            values[m["name"]] = e2e[m["name"]]
    units = {m["name"]: m["unit"] for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}

    route.release()
    run.free_program()
    t_check = time.perf_counter()
    with NoTF32():
        checked = route.check(window)
    log(f"check against the reference {time.perf_counter() - t_check:.3f} s")
    limits = run.cell["limits"]
    compared = {k: {"value": checked[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    result = {
        "correct": bool(correct),
        "attempted": window.frames,
        "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device_info(run, peak, tracer.result if traced else None),
    }
    if traced:
        tr = tracer.result
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops()],
                               "idle_gaps": [list(x) for x in tr.idle_gaps()]}
    result["checked"] = compared
    return result


def device_info(run: Run, peak: int, tr) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if tr is not None:
        info["busy_s"] = tr.busy_seconds()
        info["window_s"] = (tr.window[1] - tr.window[0]) / 1e6
    return info


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="flowbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    spec = spec_mod.Spec()
    chips = spec.cells()[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"flowbench: the cell {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0, spec)
    found = forbidden_modules()
    if found:
        print(f"flowbench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"checked {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
