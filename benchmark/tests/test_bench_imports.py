"""No run loads JAX or the JAX package (top-level names compared whole:
the program's name begins with the JAX package's), the reference imports
nothing of the program, and a run without a card or without the program
beside it prints no result and exits non-zero."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

REPO = harness.ROOT


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "realtime_yukarin_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.setitem(sys.modules, "flaxen.sub", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "realtime_yukarin_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.banned_modules() == ["jax", "realtime_yukarin_tpu"]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    (REPO / "benchmark" / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert not names & {harness.PROGRAM, *harness.BANNED}
    assert names <= {"benchmark", "torch", "numpy", "math", "functools",
                     "dataclasses", "wave", "__future__", "typing",
                     "pathlib", "json", "collections", "yaml"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.lanes, "
            "benchmark.reference.training; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & {harness.PROGRAM, *harness.BANNED}


def test_harness_and_drivers_load_no_jax():
    code = ("import sys; from benchmark import harness; "
            "[harness.driver(d) for d in ('serve', 'train')]; "
            "import realtime_yukarin_tpu_torch.parallel.serving, "
            "realtime_yukarin_tpu_torch.training.train_step; "
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "default.serve512", "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
