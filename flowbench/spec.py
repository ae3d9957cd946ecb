"""The benchmark's data, found by name: BENCHMARK.json at the repository's
root, and under this directory configs/<config>.json, workloads/<cell>.json,
traffic/<traffic>.json, routes/<route>.py and metrics/<metric>.py.  Adding a
cell, a configuration, a traffic mix, a route or a metric adds files and
list entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(module_name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files it names.  `home` is this directory
    (tests point it at a copy)."""

    def __init__(self, home: Path = HERE, benchmark: Optional[Path] = None):
        self.home = Path(home)
        self.bench = read_json(benchmark or self.home.parent / "BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._named("configs", name, ".json")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name, ".json")

    def traffic(self, name: str) -> dict:
        return self._named("traffic", name, ".json")

    def metric_module(self, name: str) -> ModuleType:
        return _load(f"flowbench_metric_{name.replace('.', '_').replace('-', '_')}", self._path("metrics", name, ".py"))

    def route_module(self, name: str) -> ModuleType:
        """routes/<name>.py, as a module of the package flowbench.routes (its
        relative imports reach the harness's modules)."""
        return _load(f"flowbench.routes.{name}", self._path("routes", name, ".py"))

    def _path(self, kind: str, name: str, suffix: str) -> Path:
        if not NAME_RE.match(name):
            raise ValueError(f"not a name: {name!r}")
        path = self.home / kind / f"{name}{suffix}"
        if not path.exists():
            raise FileNotFoundError(f"{kind[:-1]} {name!r}: no file {path}")
        return path

    def _named(self, kind: str, name: str, suffix: str) -> dict:
        return read_json(self._path(kind, name, suffix))

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics that `cell` reports."""
        return [m for m in self.bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that a traced run of `cell` tries: every one
        whose end-to-end metric the cell reports and whose `workloads` list,
        where it has one, names the cell (a reader that finds nothing to read
        in the cell returns None)."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if m["moves"] in moved and ("workloads" not in m or cell in m["workloads"])]

    def cells(self) -> Dict[str, dict]:
        return {w["name"]: w for w in self.bench["workloads"]}
