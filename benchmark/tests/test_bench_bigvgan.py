"""The ``serve_bigvgan`` driver's cell at a tiny size on the CPU, as
``test_bench_vocoder.py`` holds the other vocoder cells: a sound run is
correct; a program whose activation loses its anti-aliasing (the snake
with no Up2 and Down2) or is a leaky ReLU in the snake's place is not; the
control fails the cell's limits where the program meets them; and the
benchmark's count of the generator (``formulas_bigvgan``) is the
program's (``model_stage_flops``).  The generator is shrunk here beside
the tiny widths (64 initial channels for its six stages, resblock kernels
3 and 5 at dilations 1 and 3)."""

import json

import pytest
import torch

from benchmark import formulas_bigvgan, harness
from benchmark.readings import readings

from conftest import make_tiny_root

CELL = "bigvgan.serve128"
TINY_GENERATOR = {"upsample_initial_channel": 64,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3], [1, 3]]}


@pytest.fixture
def bigvgan_root(tmp_path):
    root = make_tiny_root(tmp_path)
    f = root / "benchmark" / "configs" / "bigvgan.json"
    doc = json.loads(f.read_text())
    doc["config"]["vocoder_bigvgan"].update(TINY_GENERATOR)
    f.write_text(json.dumps(doc))
    return root


def test_a_sound_run_is_correct(bigvgan_root, run_tiny):
    """Traced: the new readers find nothing to read on the CPU and give
    nothing, without raising."""
    res = run_tiny(bigvgan_root, CELL, trace=1, seconds=6.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _snake_only(v, alpha, inv_beta):
    """SnakeBeta without its 2x resampling: aliasing left in."""
    a, b = alpha[None, None], inv_beta[None, None]
    return v + torch.sin(a * v) ** 2 * b


def _leaky_relu(v, alpha, inv_beta):
    return torch.where(v > 0, v, 0.1 * v)


@pytest.mark.parametrize("fault", [_snake_only, _leaky_relu],
                         ids=["no_antialiasing", "leaky_relu"])
def test_a_wrong_activation_is_not_correct(bigvgan_root, run_tiny,
                                           monkeypatch, fault):
    from realtime_yukarin_tpu_torch.ops import bigvgan_act
    monkeypatch.setattr(bigvgan_act, "activation", fault)
    assert not run_tiny(bigvgan_root, CELL)["correct"]


def test_the_control_is_not_correct(bigvgan_root):
    limits = harness.load_cell(CELL, bigvgan_root).limits
    for r in readings(CELL, [2 ** 31 + 13], 6.0, torch.device("cpu"),
                      bigvgan_root):
        n = r["numbers"]
        assert all(n[k] <= spec["limit"] for k, spec in limits.items()), n
        assert any(n[f"control_{k}"] > spec["limit"]
                   for k, spec in limits.items()), n


def test_the_formulas_count_the_generator_as_the_program_does():
    """``model_stage_flops`` of a bigvgan server (the program's count of
    its convolutions over the cone and of its activation passes) equals
    ``formulas_bigvgan``'s, at two lanes of the tiny generator; and the
    published generator's count is the one ``BENCHMARK.json`` states."""
    from benchmark.reference.config import Config as RefConfig
    from benchmark.reference.models.vocoder_bigvgan import BigVGANConfig
    from benchmark.reference.streaming import bigvgan as ref_bigvgan
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    from realtime_yukarin_tpu_torch.parallel.serving import (
        BatchedServer, model_stage_flops)
    d = {"acoustic": {"hidden": 32, "num_blocks": 2},
         "vocoder_bigvgan": TINY_GENERATOR, "vocoder_mode": "bigvgan",
         "compute_dtype": "float32"}
    cfg = Config.from_dict(d)
    ref_d, b = ref_bigvgan.split_config(d)
    ref_cfg = RefConfig.from_dict(ref_d)
    server = BatchedServer(init_params(cfg, torch.Generator().manual_seed(0)),
                           cfg, num_streams=2, vocoder_mode="bigvgan",
                           device="cpu")
    counted = model_stage_flops(server)
    halo = ref_bigvgan.halo_frames(b)
    Fc = ref_cfg.streaming.chunk_frames(ref_cfg.dsp)
    assert counted["vocoder_bigvgan"] == formulas_bigvgan.generator_flops(
        b, 67, 2, Fc + 1 + 2 * halo, halo, ref_cfg.dsp.hop)
    geo = ref_bigvgan.geometry(ref_cfg, b)
    assert sum(counted.values()) == 2 * formulas_bigvgan.serve_learned_flops(
        ref_cfg, geo, b, halo)
    published = BigVGANConfig()
    h = ref_bigvgan.halo_frames(published)
    assert h == 68
    flops = formulas_bigvgan.generator_flops(published, 67, 1, 21 + 2 * h,
                                             h, 120)
    assert 83e9 < flops < 84e9
