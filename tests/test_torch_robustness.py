"""Input-level robustness gates of tests/test_robustness.py, run through the
port: the F0 track of ``pipeline.offline_analyze`` (the analysis program;
eager on a length's first call, the program after) on the formant fixture
under gain, DC offset, low gain under DC, white noise at 20 dB, the 10 dB
floor (white and pink), the known-weak pink row at 20 dB, reverberation at
T60 = 0.15 s and hard clipping, and the full offline conversion's gain
linearity and DC offset, at the same thresholds against the same truths.
CPU, the default DspConfig; the conversion rows at the default Config
from the port's own identity init."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.voice_changer import init_params
from realtime_yukarin_tpu_torch.pipeline import (offline_analyze,
                                                 offline_convert)
from realtime_yukarin_tpu_torch.streaming.pipeline import noise_key_from_seed

from conftest import make_formant_utterance

CFG = Config()
PINK_B = [0.049922035, -0.095993537, 0.050612699, -0.004408786]
PINK_A = [1, -2.494956002, 2.017265875, -0.522189400]


def _cents(a, b):
    return 1200.0 * np.abs(np.log2(a / b))


def _f0(x, F) -> np.ndarray:
    return offline_analyze(np.asarray(x, np.float32), CFG, F,
                           device="cpu").f0.numpy()


@pytest.fixture(scope="module")
def formant_case():
    x, f0_true, voiced_true = make_formant_utterance(
        1.0, CFG.dsp.sample_rate, seed=0)
    F = len(x) // CFG.dsp.hop
    return x, f0_true[:F], voiced_true[:F], F, _f0(x, F)


def _gate(xin, f0_true, vt, F, base, *, false_max=0.05, p50_max=15.0,
          agree_min=0.99, dcents_max=2.0):
    j = _f0(xin, F)
    recall = (j[vt] > 0).mean()
    false_voice = (j[~vt] > 0).mean()
    assert recall > 0.95, f"recall {recall:.3f}"
    assert false_voice < false_max, f"false voicing {false_voice:.3f}"
    v = vt & (j > 0)
    err = _cents(j[v], f0_true[v])
    assert np.percentile(err, 50) < p50_max, f"p50 {np.median(err):.1f}"
    assert (err > 600).sum() == 0, f"{(err > 600).sum()} octave frames"
    agree = ((base > 0) == (j > 0)).mean()
    assert agree >= agree_min, f"voicing agreement vs clean {agree:.3f}"
    both = (base > 0) & (j > 0)
    dd = _cents(j[both], base[both])
    assert np.percentile(dd, 95) < dcents_max, (
        f"f0 drift vs clean p95 {np.percentile(dd, 95):.2f} cents")


def _acoustic_metrics(xin, f0_true, vt, F):
    j = _f0(xin, F)
    recall = (j[vt] > 0).mean()
    false_voice = (j[~vt] > 0).mean()
    v = vt & (j > 0)
    err = _cents(j[v], f0_true[v]) if v.any() else np.array([np.inf])
    return recall, false_voice, err


@pytest.mark.parametrize("gain", [1e-3, 1e-2, 0.1, 10.0])
def test_f0_gain_invariance(formant_case, gain):
    x, f0_true, vt, F, base = formant_case
    _gate(gain * x, f0_true, vt, F, base)


def test_f0_dc_offset(formant_case):
    x, f0_true, vt, F, base = formant_case
    _gate(x + 0.1, f0_true, vt, F, base)


def test_f0_low_gain_plus_dc(formant_case):
    x, f0_true, vt, F, base = formant_case
    _gate(0.01 * x + 0.1, f0_true, vt, F, base)


def test_f0_white_noise_20db(formant_case):
    x, f0_true, vt, F, _ = formant_case
    rng = np.random.default_rng(7)
    nz = rng.standard_normal(len(x))
    nz *= np.sqrt((x ** 2).mean() / (nz ** 2).mean()) / 10.0
    rec, fv, err = _acoustic_metrics(x + nz, f0_true, vt, F)
    assert rec > 0.9, f"recall {rec:.3f}"
    assert fv < 0.15, f"false voicing {fv:.3f}"
    assert np.median(err) < 15.0, f"p50 {np.median(err):.1f}"
    assert (err > 600).sum() <= 3, f"{(err > 600).sum()} octave frames"


def test_f0_noise_floor_graceful(formant_case):
    x, f0_true, vt, F, _ = formant_case
    rng = np.random.default_rng(7)
    rms = np.sqrt((x ** 2).mean())
    white = rng.standard_normal(len(x))
    white *= rms / np.sqrt((white ** 2).mean()) / 10 ** 0.5
    pink = ss.lfilter(PINK_B, PINK_A, rng.standard_normal(len(x)))
    pink *= rms / np.sqrt((pink ** 2).mean()) / 10 ** 0.5
    for name, nz in (("white10", white), ("pink10", pink)):
        rec, fv, err = _acoustic_metrics(x + nz, f0_true, vt, F)
        assert fv < 0.05, f"{name}: hallucinated voicing {fv:.3f}"
        finite = err[np.isfinite(err)]
        assert (finite > 600).sum() == 0, f"{name}: octave artifacts"


def test_f0_pink_noise_20db_known_weak(formant_case):
    """The JAX package's known-weak row (recall 0.280 there), pinned at
    its gates."""
    x, f0_true, vt, F, _ = formant_case
    rng = np.random.default_rng(8)
    pink = ss.lfilter(PINK_B, PINK_A, rng.standard_normal(len(x)))
    pink *= np.sqrt((x ** 2).mean() / (pink ** 2).mean()) / 10.0
    rec, fv, err = _acoustic_metrics(x + pink, f0_true, vt, F)
    assert rec > 0.15, f"recall collapsed further: {rec:.3f}"
    assert fv < 0.05, f"false voicing {fv:.3f}"
    assert (err[np.isfinite(err)] > 600).sum() <= 18


def test_f0_reverberation(formant_case):
    x, f0_true, vt, F, _ = formant_case
    fs = CFG.dsp.sample_rate
    r = np.random.default_rng(7)
    n = int(0.15 * fs)
    tail = r.standard_normal(n) * np.exp(-6.9 * np.arange(n) / n)
    rir = np.concatenate([[1.0], 0.25 * tail])
    rir /= np.sqrt((rir ** 2).sum())
    y = np.convolve(x, rir)[: len(x)]
    rec, fv, err = _acoustic_metrics(y, f0_true, vt, F)
    assert rec > 0.75, f"recall {rec:.3f}"
    assert fv < 0.25, f"false voicing {fv:.3f}"
    assert np.median(err) < 20.0, f"p50 {np.median(err):.1f}"
    assert (err > 600).sum() <= 22


def test_f0_hard_clipping(formant_case):
    x, f0_true, vt, F, base = formant_case
    _gate(np.clip(3.0 * x, -1.0, 1.0), f0_true, vt, F, base)


@pytest.fixture(scope="module")
def conversion():
    """(convert(wave) at the default Config from the port's identity init
    with the seed-7 noise, the 0.5 s formant utterance, F, hop)."""
    x, _, _ = make_formant_utterance(0.5, CFG.dsp.sample_rate, seed=1)
    hop = CFG.dsp.hop
    F = len(x) // hop
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    key = noise_key_from_seed(7)

    def convert(w):
        return offline_convert(params, np.asarray(w, np.float32), key, CFG,
                               F, device="cpu").numpy()
    return convert, x, F, hop


def test_full_conversion_gain_linearity(conversion):
    convert, x, _, _ = conversion
    y1 = convert(x)
    scale = np.abs(y1).max() + 1e-12
    for g in (0.01, 10.0):
        np.testing.assert_allclose(convert(g * x) / g / scale, y1 / scale,
                                   rtol=0, atol=2e-3)


def test_full_conversion_dc_offset(conversion):
    convert, x, _, hop = conversion
    m = 12 * hop
    y1 = convert(x)
    scale = np.abs(y1).max() + 1e-12
    err = np.abs(convert(x + 0.1) - y1)[m:-m].max() / scale
    assert err < 1e-4, f"DC-offset conversion deviates {err:.2e} of peak"
    yg = convert(0.01 * x + 0.1)
    err_g = np.abs(yg - 0.01 * y1)[m:-m].max() / (0.01 * scale)
    assert err_g < 1e-3, (
        f"x0.01-gain + DC conversion deviates {err_g:.2e} of scaled peak")
