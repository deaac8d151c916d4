"""The benchmark stands apart from the JAX package: no module under
``bench/`` imports ``jax``, ``jaxlib``, ``flax`` or ``repro`` (top-level
names compared whole, since ``repro_torch`` begins with ``repro``), the
reference imports nothing of the program, and a run without a card or
without the program prints no result."""
import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _files():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax_or_repro(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN + ("repro_torch", "chip_smoke")]
    assert not bad, f"{path} imports {bad}"


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "bench", "torch"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core", "jax.numpy", "jaxlib", "flax", "numpy"]) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core"]


def _run(cwd):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "sift1m.b10k",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_run_without_a_card_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and _no_result(proc), proc.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc), proc.stderr
    assert not (tmp_path / "src").exists()
    json.loads((tmp_path / "BENCHMARK.json").read_text())
