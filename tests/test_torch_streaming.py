"""The port's streaming layer against the JAX package's: geometry (every
vocoder mode, client rates), the initial carry, the position-deterministic
noise, and the whole default streaming step end to end (VoiceChangerStream
on both sides, the same weights, noise permutation and input); the other
vocoder modes and client rates end to end are in
test_torch_streaming_modes.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_yukarin_tpu.config import Config, StreamingConfig
from realtime_yukarin_tpu.streaming import pipeline as j_pipe
from realtime_yukarin_tpu.streaming import state as j_state
from realtime_yukarin_tpu.streaming.stream import VoiceChangerStream as JStream
from realtime_yukarin_tpu_torch import pipeline as t_offline
from realtime_yukarin_tpu_torch.cli import convert as t_convert
from realtime_yukarin_tpu_torch.models.voice_changer import init_params
from realtime_yukarin_tpu_torch.streaming import pipeline as t_pipe
from realtime_yukarin_tpu_torch.streaming import state as t_state
from realtime_yukarin_tpu_torch.streaming.stream import (
    VoiceChangerStream as TStream)

from conftest import make_test_signal
from torch_parity import configs, perturbed_params, rel_to_peak

KEY_SEED = 3


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    jp, tp, _ = perturbed_params(jc, tc)
    return jc, tc, jp, tp


def _rates(cfg, rate_in, rate_out):
    return dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=rate_in, output_rate=rate_out))


def _geometry_cases():
    base = Config()
    return {
        "default_sr": (base, True, "dsp"),
        "default_no_sr": (base, False, "dsp"),
        "40ms": (dataclasses.replace(
            base, streaming=StreamingConfig(chunk_ms=40.0)), True, "dsp"),
        "causal_snap_20ms": (dataclasses.replace(
            base, dsp=dataclasses.replace(base.dsp, f0_snap_halo=0,
                                          f0_snap_left=6),
            streaming=StreamingConfig(chunk_ms=20.0)), True, "dsp"),
        "ddsp": (base, True, "ddsp"),
        "wave_no_sr": (base, False, "wave"),
        "16k_in_48k_out": (_rates(base, 16000, 48000), True, "dsp"),
        "48k_in_8k_out_40ms_wave": (dataclasses.replace(
            _rates(base, 48000, 8000),
            streaming=StreamingConfig(chunk_ms=40.0)), True, "wave"),
    }


@pytest.mark.parametrize("case", list(_geometry_cases()))
def test_geometry_matches_jax(case):
    jc, use_sr, mode = _geometry_cases()[case]
    _, tc = configs(jc)
    jg = j_state.StreamGeometry.from_config(jc, use_sr, vocoder_mode=mode)
    tg = t_state.StreamGeometry.from_config(tc, use_sr, vocoder_mode=mode)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    for name in ("cache_frames", "stage1_cache_frames", "fresh_frames"):
        assert getattr(jg, name) == getattr(tg, name), name
    assert jg.latency_out_samples(jc.dsp) == tg.latency_out_samples(tc.dsp)
    assert jg.latency_samples(jc.dsp.hop) == tg.latency_samples(tc.dsp.hop)
    for plan in ("input_plan", "output_plan"):
        assert (dataclasses.asdict(getattr(j_state, plan)(
                    jc.dsp, jg.chunk_samples))
                == dataclasses.asdict(getattr(t_state, plan)(
                    tc.dsp, tg.chunk_samples))), plan


def test_input_plan_refuses_a_chunk_off_the_client_grid():
    """A 5 ms chunk at 24 kHz (120 samples) is 14.7 samples at 44.1 kHz:
    both packages refuse it."""
    jc = _rates(Config(streaming=StreamingConfig(chunk_ms=5.0)), 44100,
                None)
    _, tc = configs(jc)
    for state, cfg in ((j_state, jc), (t_state, tc)):
        with pytest.raises(ValueError, match="divisible by both rates"):
            state.StreamGeometry.from_config(cfg)


def test_stream_carry_init_matches_jax(setup):
    jc, tc, jp, tp = setup
    jcarry, jg = j_pipe.init_stream(jp, jc)
    tcarry, tg = t_pipe.init_stream(tp, tc, device="cpu")
    assert tcarry.frame_pos == int(jcarry.frame_pos) == -jg.delay_frames
    for name in ("wave_buf", "f0_cache", "mc_cache", "ap_cache",
                 "f0_raw_prev", "f0_cand_prev", "f0_cost_prev",
                 "mc_c_cache"):
        t, j = getattr(tcarry, name).numpy(), np.asarray(getattr(jcarry,
                                                                 name))
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5, err_msg=name)
    for a, b in zip(tcarry.stage1_acts, jcarry.stage1_acts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(tcarry.synth.noise_tail.numpy(),
                                  np.asarray(jcarry.synth.noise_tail))
    assert tcarry.rs_in is None and tcarry.rs_out is None


def _same_leaves(t_obj, j_obj, names):
    for name in names:
        np.testing.assert_array_equal(getattr(t_obj, name).numpy(),
                                      np.asarray(getattr(j_obj, name)),
                                      err_msg=name)


@pytest.mark.parametrize("start", [-45, -4097, 0, 4090, 3 * 4096 - 7])
def test_frame_noise_matches_jax(start):
    key = jax.random.key(KEY_SEED)
    bits = np.asarray(jax.random.bits(key, (3,), jnp.uint32))
    noise_key = t_pipe.noise_key_from_bits(bits)
    bins = t_state.noise_bins(configs(Config())[1])
    j = np.asarray(j_pipe.frame_noise(key, start, 20, bins))
    t = t_pipe.frame_noise(noise_key, start, 20, bins, torch.zeros(1))
    np.testing.assert_array_equal(t.numpy(), j)


def test_noise_key_from_seed_is_odd_and_deterministic():
    a, b = t_pipe.noise_key_from_seed(5), t_pipe.noise_key_from_seed(5)
    assert a == b != t_pipe.noise_key_from_seed(6)
    assert a[1] % 2 == 1 and a[2] % 2 == 1
    assert all(0 <= v < t_pipe.NOISE_TABLE_FRAMES for v in a)
    for bad in (-1, 2 ** 32):
        with pytest.raises(ValueError):
            t_pipe.noise_key_from_seed(bad)


@pytest.mark.parametrize("seed", [0, 1, KEY_SEED, 12345, 2 ** 31 + 5,
                                  2 ** 32 - 1])
def test_noise_key_from_seed_matches_jax_key(seed):
    """A seed means the same noise in both packages: the port's key from
    ``seed`` is the one ``jax.random.key(seed)`` gives."""
    bits = np.asarray(jax.random.bits(jax.random.key(seed), (3,),
                                      jnp.uint32))
    assert t_pipe.noise_key_from_seed(seed) == t_pipe.noise_key_from_bits(
        bits)


def _stream(stream, x):
    """Push x chunk by chunk, flush; return (output on the input timeline,
    at the output rate, voicing of the frames made final by each step)."""
    S = stream.chunk_samples
    outs, voicing = [], []
    for k in range(len(x) // S):
        stream.add(x[k * S: (k + 1) * S])
        outs.append(stream.process())
        voicing.append(np.asarray(stream._carry.f0_cache[-20:]) > 0)
    outs.append(stream.flush())
    y = np.concatenate(outs)
    lat = stream.latency_samples
    n = len(x) * stream.chunk_out_samples // S
    return y[lat: lat + n], np.stack(voicing)


def _noise_key():
    key = jax.random.key(KEY_SEED)
    return key, t_pipe.noise_key_from_bits(
        np.asarray(jax.random.bits(key, (3,), jnp.uint32)))


@pytest.mark.parametrize("use_sr", [True, False])
@pytest.mark.parametrize("kind", ["sweep", "formant"])
def test_streaming_slice_matches_jax(setup, kind, use_sr):
    """The whole default step: torch VoiceChangerStream == JAX
    VoiceChangerStream to 2e-3 of the peak (the streamed == offline
    tolerance of tests/test_streaming.py), identical voicing."""
    jc, tc, jp, tp = setup
    x = make_test_signal(kind, 1.0, jc.dsp.sample_rate).astype(np.float32)
    key = jax.random.key(KEY_SEED)
    noise_key = t_pipe.noise_key_from_bits(
        np.asarray(jax.random.bits(key, (3,), jnp.uint32)))
    yj, vj = _stream(JStream(jp, jc, use_sr, key=key), x)
    yt, vt = _stream(TStream(tp, tc, use_sr, noise_key=noise_key,
                             device="cpu"), x)
    assert yt.shape == yj.shape == x.shape
    assert vj.any() and not vj.all()
    np.testing.assert_array_equal(vt, vj)
    assert rel_to_peak(yt, yj) < 2e-3


def test_silence_in_silence_out(setup):
    """With freshly initialised weights (identity stages), as in
    tests/test_streaming.py."""
    _, tc, _, _ = setup
    params = init_params(tc, torch.Generator().manual_seed(0))
    stream = TStream(params, tc, device="cpu")
    stream.add(np.zeros(stream.chunk_samples * 4, np.float32))
    y = stream.process()
    assert y.shape == (stream.chunk_samples * 4,)
    assert np.isfinite(y).all()
    assert np.abs(y).max() < 1e-3


def test_entry_points_never_fall_back_to_cpu(setup):
    _, tc, _, tp = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TStream(tp, tc)
    x = np.zeros(2400, np.float32)
    for mode in ("dsp", "ddsp", "wave"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_pipe.init_stream(tp, tc, vocoder_mode=mode)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TStream(tp, _rates(tc, 16000, 48000), vocoder_mode=mode)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_offline.offline_convert(tp, x, (0, 1, 1), tc, 20,
                                      vocoder_mode=mode)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_offline.offline_convert_io(tp, x, (0, 1, 1), tc,
                                         vocoder_mode=mode)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_offline.offline_analyze(x, tc, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_convert.main(["--input_path", "in.wav", "--output_path",
                        "out.wav"])
