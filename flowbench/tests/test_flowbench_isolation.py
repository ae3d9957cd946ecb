"""Isolation: the plain reference imports nothing of JAX, the JAX package or
the program; the harness imports nothing of JAX or the JAX package; the
run's module check compares whole top-level names; a run without a card, or
in a checkout without the program, fails and prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from flowbench import harness, spec as spec_mod

HOME = spec_mod.HERE


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_jax_or_the_program():
    for path in sorted((HOME / "reference").rglob("*.py")):
        assert not imported_tops(path) & {"jax", "jaxlib", "flax", "tpuflow", "tpuflow_torch"}, path


def test_harness_imports_nothing_of_jax():
    for path in sorted(HOME.rglob("*.py")):
        assert not imported_tops(path) & {"jax", "jaxlib", "flax", "tpuflow"}, path


def test_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["tpuflow_torch", "tpuflow_torch.core", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["tpuflow", "tpuflow.core.sk", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "tpuflow", "tpuflow.core.sk"]


def run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "flowbench/run.py", "--workload", "memflow-stream-1080p", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env={**os.environ, **(env or {})}, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_without_a_result():
    res = run_py(spec_mod.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(HOME, tmp_path / "flowbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", tmp_path)
    res = run_py(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    res = run_py(spec_mod.ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
