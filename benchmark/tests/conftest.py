"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository root (tests that need the card are marked ``cuda`` and skip
here).  Runs here are the harness's own at a tiny size on the CPU: a copy of
``benchmark/`` beside the program, every cell's widths and traffic shrunk,
the program in float32 so that a sound run meets the reference."""

import json
import os
import pathlib
import shutil
import sys
import time

# one thread per test process: the runs here are timed windows, and
# several workers sharing the cores must not starve each other's ticks
os.environ.setdefault("OMP_NUM_THREADS", "1")

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

TINY_WIDTHS = {"acoustic": {"hidden": 32}, "super_resolution": {"hidden": 64},
               "vocoder_nn": {"hidden": 32}, "vocoder_wave": {"hidden": 32}}
TINY_TRAFFIC = {
    "serve": {"lanes": 6, "warmup_steps": 1, "trace_steps": 2,
              "call_s": 10.0, "pause_share": 0.34,
              "pool": {"signals": 3, "seconds": 2.0},
              "check": {"lanes": 6, "ring_s": 10.0}},
    "train": {"bucket_frames": 32, "crop_frames": 20, "batch_size": 2,
              "trace_steps": 2, "corpus": {"pairs": 4, "seconds": [0.6, 0.9]}},
}


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


def _merge(doc: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict):
            _merge(doc[k], v)
        else:
            doc[k] = v


def make_tiny_root(tmp: pathlib.Path, program_dtype: str = "float32"
                   ) -> pathlib.Path:
    """A checkout of the benchmark at a tiny size under ``tmp``."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / harness.PROGRAM).symlink_to(REPO / harness.PROGRAM)
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for f in (tmp / "benchmark" / "configs").glob("*.json"):
        doc = json.loads(f.read_text())
        _merge(doc["config"], TINY_WIDTHS)
        doc["config"]["compute_dtype"] = program_dtype
        f.write_text(json.dumps(doc))
    for f in (tmp / "benchmark" / "traffic").glob("*.json"):
        doc = json.loads(f.read_text())
        _merge(doc, TINY_TRAFFIC[doc["driver"]])
        f.write_text(json.dumps(doc))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def _run_tiny(root, workload: str, seconds: float = 3.0, trace: int = 0,
              seed: int = 2 ** 31 + 7):
    """One run of the harness on the CPU; its result object."""
    import torch
    return harness.run(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       time.perf_counter(), device=torch.device("cpu"),
                       root=root)


@pytest.fixture
def run_tiny():
    return _run_tiny
