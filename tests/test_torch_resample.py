"""The port's polyphase resampler against the JAX package's (the plan and
the matrix bit-equal, the streamed chunks within the JAX golden test's
5e-5, the one-shot signal within 1e-6 of the streamed concatenation), and
across client rates: streamed == offline_convert_io within the port
(``tests/test_resample.py``'s cross-rate gate) and offline_convert_io
against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_yukarin_tpu import pipeline as j_pl
from realtime_yukarin_tpu.dsp import resample as j_rs
from realtime_yukarin_tpu_torch import pipeline as t_pl
from realtime_yukarin_tpu_torch.dsp import resample as t_rs
from realtime_yukarin_tpu_torch.streaming.pipeline import noise_key_from_seed
from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

from conftest import make_test_signal
from torch_parity import ALL_NETS, configs, perturbed_params, rel_to_peak

RATES = [(16000, 24000), (24000, 16000), (8000, 24000), (48000, 24000)]


def _plans(rate_in, rate_out):
    chunk_in = rate_in // 10                      # 100 ms chunks
    return (j_rs.make_plan(rate_in, rate_out, chunk_in, align_delay_to=120),
            t_rs.make_plan(rate_in, rate_out, chunk_in, align_delay_to=120))


@pytest.mark.parametrize("rate_in,rate_out", RATES)
def test_plan_and_matrix_bit_equal_to_jax(rate_in, rate_out):
    jp, tp = _plans(rate_in, rate_out)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert (t_rs.KAISER_BETA, t_rs.HALF_WIDTH, t_rs.ROLLOFF) == (
        j_rs.KAISER_BETA, j_rs.HALF_WIDTH, j_rs.ROLLOFF)
    jm, tm = j_rs._matrix_np(jp), t_rs._matrix_np(tp)
    assert tm.dtype == jm.dtype == np.float32
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("rate_in,rate_out", RATES)
def test_resample_stream_matches_jax(rate_in, rate_out):
    """Three streamed chunks within 5e-5 of the JAX package's (its golden
    test's bound); the one-shot signal within 1e-6 of the streamed
    concatenation (its bound too)."""
    jp, tp = _plans(rate_in, rate_out)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(3 * tp.chunk_in).astype(np.float32) * 0.3
    jcarry, tcarry = j_rs.init_carry(jp), t_rs.init_carry(tp, "cpu")
    assert tuple(tcarry.shape) == tuple(jcarry.shape) == (tp.history,)
    j_out, t_out = [], []
    for k in range(3):
        chunk = x[k * tp.chunk_in: (k + 1) * tp.chunk_in]
        y, jcarry = j_rs.resample_chunk(jcarry, jnp.asarray(chunk), jp)
        j_out.append(np.asarray(y))
        y, tcarry = t_rs.resample_chunk(tcarry, torch.from_numpy(chunk), tp)
        t_out.append(y.numpy())
        np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
    streamed = np.concatenate(t_out)
    assert streamed.shape == (3 * tp.chunk_out,)
    np.testing.assert_allclose(streamed, np.concatenate(j_out), atol=5e-5)
    one = t_rs.resample_signal(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(one, streamed, atol=1e-6)
    # a ragged length is trimmed to floor(T * L / M), as in the JAX package
    ragged = x[: 2 * tp.chunk_in + 7]
    np.testing.assert_allclose(
        t_rs.resample_signal(torch.from_numpy(ragged), tp).numpy(),
        np.asarray(j_rs.resample_signal(jnp.asarray(ragged), jp)),
        atol=5e-5)


def test_resample_tone_fidelity():
    """A 1 kHz tone upsampled 16k->24k keeps amplitude and frequency;
    images/aliases stay below -80 dB of the carrier."""
    rate_in, rate_out, f = 16000, 24000, 1000.0
    plan = t_rs.make_plan(rate_in, rate_out, 1600)
    t = np.arange(10 * 1600) / rate_in
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32))
    y = t_rs.resample_signal(x, plan).numpy()
    skip = 4 * t_rs.HALF_WIDTH * rate_out // rate_in + plan.delay_out
    seg = y[skip: len(y) - skip]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1.0 / rate_out)
    k = np.argmax(spec)
    assert abs(freqs[k] - f) < 2.0
    assert abs(np.sqrt((seg ** 2).mean()) / (0.5 / np.sqrt(2)) - 1) < 2e-3
    assert spec[np.abs(freqs - f) > 50.0].max() < spec[k] * 10 ** (-80 / 20)


def test_identity_plan_passthrough():
    plan = t_rs.make_plan(24000, 24000, 2400)
    x = torch.arange(2400, dtype=torch.float32)
    y, carry = t_rs.resample_chunk(t_rs.init_carry(plan, "cpu"), x, plan)
    assert carry is None and y is x and plan.delay_out == 0
    assert t_rs.resample_signal(x, plan) is x


def test_plan_rejects_unaligned_chunk():
    with pytest.raises(ValueError):
        t_rs.make_plan(16000, 24000, 1601)


def _cross_rate(cfg):
    return dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=16000, output_rate=48000))


def test_streamed_equals_offline_cross_rate():
    """16 kHz in -> 48 kHz out: the port's stream (resample edges inside
    the step) equals its offline_convert_io on the interior, shifted by
    the pipeline delay (the resampler delays are inside both)."""
    _, tc = configs()
    cfg = _cross_rate(tc)
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0))
    geo = StreamGeometry.from_config(cfg)
    sr, out_rate = cfg.dsp.sample_rate, cfg.dsp.out_rate
    assert geo.chunk_in_samples == 1600 and geo.chunk_out_samples == 4800

    x = make_test_signal("sweep", 1.0, 16000).astype(np.float32)
    S = geo.chunk_in_samples
    x = x[: (len(x) // S) * S]
    stream = VoiceChangerStream(params, cfg, seed=0, device="cpu")
    outs = [stream.process()]
    for k in range(len(x) // S):
        stream.add(x[k * S: (k + 1) * S])
        outs.append(stream.process())
    outs.append(stream.flush())
    streamed = np.concatenate(outs)
    offline = t_pl.offline_convert_io(params, x, noise_key_from_seed(0),
                                      cfg, device="cpu").numpy()
    shift = geo.delay_frames * cfg.dsp.hop * out_rate // sr
    margin = (geo.model_ctx + 2) * cfg.dsp.hop * out_rate // sr \
        + 4 * t_rs.HALF_WIDTH * out_rate // 16000
    n = min(len(offline), len(streamed) - shift)
    a = offline[margin: n - margin]
    b = streamed[shift + margin: shift + n - margin]
    assert len(a) > out_rate // 2
    scale = np.abs(a).max() + 1e-9
    np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=2e-3)


def test_offline_convert_io_matches_jax():
    """16 kHz in, 48 kHz out, with every subtree perturbed: the resample
    edges around offline_convert, on the interior the cross-rate gate
    above uses.

    A 16 kHz client leaves the internal spectrum above 8 kHz empty, so at
    the default -70 dB envelope floor those bins sit at the floor, where
    float32 rounding moves the mel-cepstrum (ROADMAP.md §3, a fault of
    both packages; ``tools/torch_envelope_conditioning.py``: float32 vs
    float64 5.2e-3 of the mc peak on chip_smoke.py's signal through a
    16 kHz client, 3.6e-4 at a -50 dB floor), and the two packages'
    outputs part by more than 2e-3 of the peak.  The floor here is -50 dB,
    so the comparison holds the edges and not that rounding.
    """
    jc, tc = (dataclasses.replace(c, dsp=dataclasses.replace(
        c.dsp, envelope_floor_db=-50.0)) for c in map(_cross_rate, configs()))
    jp, tp, _ = perturbed_params(jc, tc, prefixes=ALL_NETS)
    x = make_test_signal("formant", 0.5, 16000).astype(np.float32)
    yj = np.asarray(j_pl.offline_convert_io(jp, jnp.asarray(x),
                                            jax.random.key(0), jc))
    yt = t_pl.offline_convert_io(tp, x, noise_key_from_seed(0), tc,
                                 device="cpu").numpy()
    assert yt.shape == yj.shape == (3 * len(x),)
    geo = StreamGeometry.from_config(tc)
    margin = (geo.model_ctx + 2) * tc.dsp.hop * 2 + 4 * t_rs.HALF_WIDTH * 3
    assert rel_to_peak(yt[margin:-margin], yj[margin:-margin]) < 2e-3
