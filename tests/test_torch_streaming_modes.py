"""The port's streaming step against the JAX package's end to end in the
ddsp and wave vocoder modes and across client rates (VoiceChangerStream on
both sides, the same weights, noise permutation and input)."""

import numpy as np
import pytest

from realtime_yukarin_tpu.streaming.stream import VoiceChangerStream as JStream
from realtime_yukarin_tpu_torch.streaming.stream import (
    VoiceChangerStream as TStream)

from conftest import make_test_signal
from test_torch_streaming import _noise_key, _rates, _same_leaves, _stream
from torch_parity import ALL_NETS, configs, perturbed_params, rel_to_peak



@pytest.fixture(scope="module")
def setup_voc():
    """Tiny float32 configs, every subtree perturbed (the vocoders' heads
    are zero at init, where both are the DSP renderer)."""
    jc, tc = configs()
    jp, tp, _ = perturbed_params(jc, tc, prefixes=ALL_NETS)
    return jc, tc, jp, tp


@pytest.mark.parametrize("mode,kind,tol", [("ddsp", "formant", 2e-3),
                                           ("wave", "speechlike", 3e-3)])
def test_streaming_vocoder_modes_match_jax(setup_voc, mode, kind, tol):
    """The ddsp and wave modes streamed by both packages (vocoder heads
    perturbed, so the control net and the residual are active): 2e-3 of
    the peak, 3e-3 for wave (the JAX package's streamed == offline
    tolerances, tests/test_streaming.py), identical voicing."""
    jc, tc, jp, tp = setup_voc
    x = make_test_signal(kind, 1.0, jc.dsp.sample_rate).astype(np.float32)
    key, noise_key = _noise_key()
    js = JStream(jp, jc, key=key, vocoder_mode=mode)
    ts = TStream(tp, tc, noise_key=noise_key, vocoder_mode=mode,
                 device="cpu")
    if mode == "wave":                   # the initial WaveCarry
        _same_leaves(ts._carry.synth, js._carry.synth,
                     ("res_tail", "frac_phase"))
        _same_leaves(ts._carry.synth.synth, js._carry.synth.synth,
                     ("phase", "voiced_prev", "noise_tail"))
    yj, vj = _stream(js, x)
    yt, vt = _stream(ts, x)
    assert yt.shape == yj.shape == x.shape
    assert vj.any() and not vj.all()
    np.testing.assert_array_equal(vt, vj)
    assert rel_to_peak(yt, yj) < tol


def test_streaming_client_rates_match_jax(setup_voc):
    """16 kHz in, 48 kHz out: both packages' resampling edges around the
    step, to 2e-3 of the peak with identical voicing."""
    jc, tc, jp, tp = setup_voc
    jc, tc = _rates(jc, 16000, 48000), _rates(tc, 16000, 48000)
    x = make_test_signal("sweep", 1.0, 16000).astype(np.float32)
    key, noise_key = _noise_key()
    js = JStream(jp, jc, key=key)
    ts = TStream(tp, tc, noise_key=noise_key, device="cpu")
    assert (ts.chunk_samples, ts.chunk_out_samples) == (1600, 4800)
    assert ts.latency_samples == js.latency_samples
    _same_leaves(ts._carry, js._carry, ("rs_in", "rs_out"))
    yj, vj = _stream(js, x)
    yt, vt = _stream(ts, x)
    assert yt.shape == yj.shape == (3 * len(x),)
    assert vj.any()
    np.testing.assert_array_equal(vt, vj)
    assert rel_to_peak(yt, yj) < 2e-3


