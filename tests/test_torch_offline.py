"""The port's offline pipeline against the JAX package's (``pipeline.py``:
offline_convert in the three vocoder modes with and without SR,
offline_analyze, offline_synthesize; convert_features / convert_window;
load_all_params; offline_convert_io is in test_torch_resample.py),
and the port's streamed output == its offline output on the interior, the
contract ``tests/test_streaming.py`` gates for the JAX package, at its
tolerances, on the tiny model config in float32."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_yukarin_tpu import pipeline as j_pl
from realtime_yukarin_tpu.config import StreamingConfig
from realtime_yukarin_tpu.dsp import world as j_world
from realtime_yukarin_tpu.models import voice_changer as j_vc
from realtime_yukarin_tpu_torch import pipeline as t_pl
from realtime_yukarin_tpu_torch.dsp import world as t_world
from realtime_yukarin_tpu_torch.models import voice_changer as t_vc
from realtime_yukarin_tpu_torch.streaming.pipeline import noise_key_from_seed
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

from conftest import make_test_signal
from test_torch_dsp import _f0_agree
from torch_parity import (ALL_NETS, configs, perturbed_params, rel_to_peak,
                          t32)

SEED = 0              # jax.random.key(SEED) <-> noise_key_from_seed(SEED)


@pytest.fixture(scope="module")
def setup():
    """Tiny float32 configs; every subtree perturbed, so the stages, the
    DDSP control net and the wave residual are all active."""
    jc, tc = configs()
    jp, tp, flat = perturbed_params(jc, tc, prefixes=ALL_NETS)
    return jc, tc, jp, tp, flat


def _signal(kind, seconds, fs=24000, hop=120):
    x = make_test_signal(kind, seconds, fs).astype(np.float32)
    return x, len(x) // hop


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_sr", [True, False])
@pytest.mark.parametrize("mode", ["dsp", "ddsp", "wave"])
def test_offline_convert_matches_jax(setup, mode, use_sr):
    jc, tc, jp, tp, _ = setup
    x, F = _signal("speechlike", 0.5)
    yj = np.asarray(j_pl.offline_convert(jp, jnp.asarray(x),
                                         jax.random.key(SEED), jc, F, use_sr,
                                         vocoder_mode=mode))
    yt = t_pl.offline_convert(tp, x, noise_key_from_seed(SEED), tc, F,
                              use_sr, vocoder_mode=mode, device="cpu")
    assert yt.shape == yj.shape == (F * tc.dsp.hop,)
    assert rel_to_peak(yt.numpy(), yj) < 2e-3


@pytest.mark.parametrize("kind", ["speechlike", "formant"])
def test_offline_analyze_matches_jax(setup, kind):
    jc, tc, *_ = setup
    x, F = _signal(kind, 0.6)
    jf = j_pl.offline_analyze(jnp.asarray(x), jc, F)
    tf = t_pl.offline_analyze(x, tc, F, device="cpu")
    _f0_agree(tf.f0, jf.f0)
    same = (tf.f0.numpy() > 0) == (np.asarray(jf.f0) > 0)
    np.testing.assert_allclose(tf.mc.numpy()[same], np.asarray(jf.mc)[same],
                               rtol=0, atol=1.2e-2)
    np.testing.assert_allclose(tf.ap.numpy()[same], np.asarray(jf.ap)[same],
                               rtol=0, atol=2e-2)


def test_offline_synthesize_matches_jax(setup):
    """The DSP render of the same (JAX-analysed) features."""
    jc, tc, *_ = setup
    x, F = _signal("sweep", 0.5)
    jf = j_world.analyze(jnp.asarray(x), F, jc.dsp)
    tf = t_world.AcousticFeature(*(t32(getattr(jf, n))
                                   for n in ("f0", "env", "ap", "mc")))
    yj = np.asarray(j_pl.offline_synthesize(jf, jax.random.key(SEED), jc))
    yt = t_pl.offline_synthesize(tf, noise_key_from_seed(SEED), tc)
    assert yt.shape == yj.shape == (F * tc.dsp.hop,)
    assert rel_to_peak(yt.numpy(), yj) < 2e-3


@pytest.mark.parametrize("use_sr", [True, False])
def test_convert_features_and_window_match_jax(setup, use_sr):
    """convert_features on a whole window and convert_window on a slice
    of it, from the same (JAX-analysed) features; the window equals the
    slice of the whole in the port."""
    jc, tc, jp, tp, _ = setup
    x, F = _signal("formant", 0.5)
    jf = j_world.analyze(jnp.asarray(x), F, jc.dsp)
    tf = t_world.AcousticFeature(*(t32(getattr(jf, n))
                                   for n in ("f0", "env", "ap", "mc")))
    jw = j_vc.convert_features(jp, jf, jc, use_sr=use_sr)
    tw = t_vc.convert_features(tp, tf, tc, use_sr=use_sr)
    t0, n, halo = 20, 21, 3
    jv = j_vc.convert_window(jp, jf, jc, t0, n, halo, use_sr=use_sr)
    tv = t_vc.convert_window(tp, tf, tc, t0, n, halo, use_sr=use_sr)
    for name in ("f0", "env", "ap", "mc"):
        np.testing.assert_array_equal(getattr(tw, name).numpy() > 0,
                                      np.asarray(getattr(jw, name)) > 0)
        assert rel_to_peak(getattr(tw, name).numpy(),
                           np.asarray(getattr(jw, name))) < 1e-4, name
        assert rel_to_peak(getattr(tv, name).numpy(),
                           np.asarray(getattr(jv, name))) < 1e-4, name
        whole = getattr(tw, name)[t0 - halo: t0 + n + halo]
        assert rel_to_peak(getattr(tv, name).numpy(), whole.numpy()) < 1e-6


def test_load_all_params_matches_jax(setup, tmp_path):
    """A full tree, then per-stage subtree files and the F0 statistics,
    through both packages' load_all_params: the same values."""
    jc, tc, jp, _, flat = setup
    full = tmp_path / "full.npz"
    np.savez(full, **flat)
    rng = np.random.default_rng(7)
    paths = {}
    for key in ("stage1", "vocoder_wave"):
        sub = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(v.dtype)
               for k, v in j_vc.flatten_params(jp[key]).items()}
        paths[key] = tmp_path / f"{key}.npz"
        np.savez(paths[key], **sub)
    stats = tmp_path / "stats.npz"
    np.savez(stats, mean=np.log(200.0), std=0.3)
    over = dict(params_path=str(full),
                stage1_params_path=str(paths["stage1"]),
                vocoder_wave_params_path=str(paths["vocoder_wave"]),
                target_statistics_path=str(stats))
    jc2, tc2 = (dataclasses.replace(c, **over) for c in (jc, tc))
    j_loaded = j_vc.load_all_params(j_vc.init_params(jax.random.key(1), jc2),
                                    jc2)
    t_init = t_vc.init_params(tc2, torch.Generator().manual_seed(1))
    t_loaded = t_vc.load_all_params(t_init, tc2)
    want = j_vc.flatten_params(j_loaded)
    got = t_vc.params_to_jax(t_loaded)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    # the caller's params are left as they were
    assert float(t_init["f0_stats"]["tgt_std"]) == pytest.approx(0.25)


def test_load_all_params_refuses_msgpack(setup, tmp_path, monkeypatch):
    """Without the msgpack module a .msgpack path is refused, naming the
    .npz layout (tests/test_torch_msgpack.py reads it with the module)."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    _, tc, _, tp, _ = setup
    for over in ({"params_path": str(tmp_path / "p.msgpack")},
                 {"stage2_params_path": str(tmp_path / "s2.msgpack")}):
        with pytest.raises(ValueError, match=r"\.npz layout"):
            t_vc.load_all_params(tp, dataclasses.replace(tc, **over))


def test_offline_entry_points_need_params_on_their_device(setup):
    _, tc, _, tp, _ = setup
    params_meta = t_vc.params_to(tp, "meta")
    with pytest.raises(ValueError, match="params_to"):
        t_pl.offline_convert(params_meta, np.zeros(2400, np.float32),
                             noise_key_from_seed(SEED), tc, 20,
                             device="cpu")


# ---------------------------------------------------------------------------
# Streamed == offline within the port (tests/test_streaming.py's gates)
# ---------------------------------------------------------------------------

def _stream_full(params, cfg, x, use_sr=True, mode="dsp"):
    """Push x through VoiceChangerStream chunk by chunk, flush; return the
    output on the input timeline and the stream."""
    stream = VoiceChangerStream(params, cfg, use_sr, seed=SEED,
                                vocoder_mode=mode, device="cpu")
    S = stream.chunk_samples
    assert len(x) % S == 0
    outs = []
    for k in range(len(x) // S):
        stream.add(x[k * S: (k + 1) * S])
        outs.append(stream.process())
    outs.append(stream.flush())
    y = np.concatenate(outs)
    lat = stream.latency_samples
    return y[lat: lat + len(x)], stream


def _streamed_vs_offline(tp, cfg, kind, seconds, use_sr=True, mode="dsp",
                         margin=2, atol=2e-3):
    x = make_test_signal(kind, seconds, cfg.dsp.sample_rate
                         ).astype(np.float32)
    S = cfg.streaming.chunk_samples(cfg.dsp)
    x = x[: (len(x) // S) * S]
    F = len(x) // cfg.dsp.hop
    offline = t_pl.offline_convert(tp, x, noise_key_from_seed(SEED), cfg, F,
                                   use_sr, vocoder_mode=mode,
                                   device="cpu").numpy()
    streamed, stream = _stream_full(tp, cfg, x, use_sr, mode)
    geo = stream._geo
    lo = (geo.model_ctx + margin) * cfg.dsp.hop
    hi = (F - geo.model_ctx - margin) * cfg.dsp.hop
    assert hi - lo >= 10 * cfg.dsp.hop
    scale = np.abs(offline[lo:hi]).max() + 1e-9
    np.testing.assert_allclose(streamed[lo:hi] / scale,
                               offline[lo:hi] / scale, rtol=0, atol=atol)
    return offline


@pytest.mark.parametrize("use_sr", [False, True])
@pytest.mark.parametrize("kind", ["sweep", "formant"])
def test_streamed_equals_offline(setup, kind, use_sr):
    _, tc, _, tp, _ = setup
    _streamed_vs_offline(tp, tc, kind, 1.0, use_sr)


@pytest.mark.parametrize("kind", ["sweep", "formant"])
def test_streamed_equals_offline_small_chunks(setup, kind):
    """40 ms chunks change the whole chunk geometry."""
    _, tc, _, tp, _ = setup
    cfg = dataclasses.replace(tc, streaming=StreamingConfig(chunk_ms=40.0))
    _streamed_vs_offline(tp, cfg, kind, 0.8)


@pytest.mark.parametrize("kind", ["sweep", "formant"])
def test_streamed_equals_offline_causal_snap(setup, kind):
    """The causal contour profile (f0_snap_halo=0, a 6-frame left window)
    at 20 ms chunks, where the left window exceeds the chunk."""
    _, tc, _, tp, _ = setup
    cfg = dataclasses.replace(
        tc, dsp=dataclasses.replace(tc.dsp, f0_snap_halo=0, f0_snap_left=6),
        streaming=StreamingConfig(chunk_ms=20.0))
    _streamed_vs_offline(tp, cfg, kind, 0.8, margin=8)


@pytest.mark.parametrize("kind", ["harmonic", "formant"])
def test_streamed_equals_offline_neural_vocoder(setup, kind):
    _, tc, _, tp, _ = setup
    _streamed_vs_offline(tp, tc, kind, 0.5, mode="ddsp")


@pytest.mark.parametrize("kind", ["speechlike", "formant"])
def test_streamed_equals_offline_wave_vocoder(setup, kind):
    """The wave mode streams equal to offline with an active residual;
    3e-3, the JAX test's tolerance (the formant fixture's stop burst)."""
    _, tc, _, tp, _ = setup
    offline_w = _streamed_vs_offline(tp, tc, kind, 0.5, mode="wave",
                                     atol=3e-3)
    x = make_test_signal(kind, 0.5, tc.dsp.sample_rate).astype(np.float32)
    offline = t_pl.offline_convert(tp, x[: len(offline_w)],
                                   noise_key_from_seed(SEED), tc,
                                   len(offline_w) // tc.dsp.hop,
                                   device="cpu").numpy()
    assert np.abs(offline_w - offline).max() > 1e-3


def test_wave_vocoder_identity_at_init():
    """Zero-init heads: the untrained wave decoder IS the DSP renderer."""
    _, tc = configs()
    params = t_vc.init_params(tc, torch.Generator().manual_seed(0))
    x, F = _signal("sweep", 0.3)
    y0, y1 = (t_pl.offline_convert(params, x, noise_key_from_seed(SEED), tc,
                                   F, vocoder_mode=mode, device="cpu")
              for mode in ("dsp", "wave"))
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
