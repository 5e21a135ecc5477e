"""On the card only: the batch-width designs of the power spectrum and the
envelope cepstrum (``csrc/power_spectrum_wide.cu``,
``csrc/envelope_cepstrum_wide.cu``) against the plain versions in float64,
and which design a batched step and a single stream launch.  Imports no
JAX, so it collects on the GPU machine; skips where there is no GPU (a CUDA
kernel has no CPU mode).  There:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_analysis_wide.py``."""

import numpy as np
import pytest
import torch

import chip_smoke
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.ops import analysis, cuda

pytestmark = pytest.mark.cuda

DESIGNS = {"power_spectrum": (cuda.POWER_SPECTRUM, cuda.POWER_SPECTRUM_WIDE),
           "envelope_cepstrum": (cuda.ENVELOPE_CEPSTRUM,
                                 cuda.ENVELOPE_CEPSTRUM_WIDE)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches() -> dict[str, int]:
    return {k.name: k.launches for k in cuda.KERNELS}


@pytest.mark.parametrize("R", [2048, 2049, 10240])
def test_wide_designs_match_float64(device, R):
    """At the serve cells' rows and a ragged one, both wrappers launch
    their wide design, once, and land within the kernels' tolerance of the
    plain version evaluated in float64."""
    cfg = Config()
    assert isinstance(analysis.power_plan(R, cfg.dsp.fft_size),
                      analysis.WidePowerPlan)
    assert isinstance(analysis.cepstrum_plan(R, cfg.dsp.spec_bins),
                      analysis.WideCepstrumPlan)
    cases = chip_smoke.kernel_cases(R, cfg, device, np.random.default_rng(R))
    for name, (cluster, wide) in DESIGNS.items():
        before = _launches()
        out = cases[name].kernel()
        torch.cuda.synchronize()
        after = _launches()
        assert after[wide.name] == before[wide.name] + 1
        assert after[cluster.name] == before[cluster.name]
        _, err = chip_smoke.abs_rel_err(out.double(), cases[name].ref64())
        assert err <= chip_smoke.TOL[name], (name, err)


def _step_counts(run) -> dict[str, int]:
    cuda.reset_counts()
    run()
    torch.cuda.synchronize()
    return _launches()


def test_batched_step_at_512_lanes_takes_the_wide_designs(device):
    """A 512-lane BatchedServer step (R = 10,240 analysis rows) raises the
    wide designs' counts by one each and leaves the cluster designs'
    alone."""
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    cfg = Config()
    server = BatchedServer(chip_smoke.seeded_params(cfg), cfg,
                           num_streams=512, device=device)
    chunks = np.zeros((512, server.chunk_samples), np.float32)
    server.step(chunks)
    counts = _step_counts(lambda: server.step(chunks))
    for cluster, wide in DESIGNS.values():
        assert counts[wide.name] == 1 and counts[cluster.name] == 0


def test_one_stream_keeps_the_cluster_designs(device):
    """A single stream's step (R = 20 rows) raises the cluster designs'
    counts by one each and leaves the wide designs' alone."""
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
    cfg = Config()
    stream = VoiceChangerStream(chip_smoke.seeded_params(cfg), cfg,
                                device=device)
    chunk = torch.zeros(stream.chunk_samples)
    stream.step_device(chunk)
    counts = _step_counts(lambda: stream.step_device(chunk))
    for cluster, wide in DESIGNS.values():
        assert counts[cluster.name] == 1 and counts[wide.name] == 0
