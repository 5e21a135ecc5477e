"""The cells of the ``serve_vocoder`` driver and the one-lane cell at a tiny
size on the CPU, as ``test_bench_correct.py`` holds the others: a sound run
is correct, a step that leaves its state unchanged is not, and the control
fails the cell's limits where the program meets them.  The generator is
shrunk here beside the tiny widths (16 initial channels, resblock kernels
3 and 5 at dilations 1 and 3)."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.readings import readings

from conftest import make_tiny_root
from test_bench_correct import _serve_unchanged

CELLS = ("hifigan.serve256", "default.live1")
TINY_GENERATOR = {"upsample_initial_channel": 16,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3], [1, 3]]}


@pytest.fixture
def vocoder_root(tmp_path):
    root = make_tiny_root(tmp_path)
    f = root / "benchmark" / "configs" / "hifigan.json"
    doc = json.loads(f.read_text())
    doc["config"]["vocoder_hifigan"].update(TINY_GENERATOR)
    f.write_text(json.dumps(doc))
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(vocoder_root, run_tiny, cell):
    res = run_tiny(vocoder_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_unchanged_state_is_not_correct(vocoder_root, run_tiny,
                                           monkeypatch, cell):
    _serve_unchanged(monkeypatch)
    assert not run_tiny(vocoder_root, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(vocoder_root, cell):
    limits = harness.load_cell(cell, vocoder_root).limits
    for r in readings(cell, [2 ** 31 + 11], 10.0, torch.device("cpu"),
                      vocoder_root):
        n = r["numbers"]
        assert all(n[k] <= spec["limit"] for k, spec in limits.items()), n
        assert any(n[f"control_{k}"] > spec["limit"]
                   for k, spec in limits.items()), n
