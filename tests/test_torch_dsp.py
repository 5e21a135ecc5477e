"""The port's DSP modules against the JAX package's, on the same seeded
inputs, at the tolerances of tests/test_dsp_golden.py (and exact where the
two compute the same values)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_yukarin_tpu.config import DspConfig
from realtime_yukarin_tpu.dsp import aperiodicity as j_ap
from realtime_yukarin_tpu.dsp import envelope as j_env
from realtime_yukarin_tpu.dsp import f0 as j_f0
from realtime_yukarin_tpu.dsp import framing as j_fr
from realtime_yukarin_tpu.dsp import mcep as j_mcep
from realtime_yukarin_tpu.dsp import primitives as j_prim
from realtime_yukarin_tpu.dsp import synthesis as j_syn
from realtime_yukarin_tpu.dsp import world as j_world
from realtime_yukarin_tpu.ops import dft as j_dft
from realtime_yukarin_tpu_torch.dsp import aperiodicity as t_ap
from realtime_yukarin_tpu_torch.dsp import envelope as t_env
from realtime_yukarin_tpu_torch.dsp import f0 as t_f0
from realtime_yukarin_tpu_torch.dsp import framing as t_fr
from realtime_yukarin_tpu_torch.dsp import mcep as t_mcep
from realtime_yukarin_tpu_torch.dsp import primitives as t_prim
from realtime_yukarin_tpu_torch.dsp import synthesis as t_syn
from realtime_yukarin_tpu_torch.dsp import world as t_world
from realtime_yukarin_tpu_torch.ops import dft as t_dft

from conftest import make_test_signal
from torch_parity import rel_to_peak, t32

CFG = DspConfig()
KINDS = ["sweep", "formant"]


def _signal(kind, seconds=0.4):
    x = make_test_signal(kind, seconds, CFG.sample_rate).astype(np.float32)
    return x, len(x) // CFG.hop


def test_primitives_equal_jax():
    fs, n, hop, B = CFG.sample_rate, CFG.fft_size, CFG.hop, CFG.num_ap_bands
    for name, args in [("hann", (n,)), ("f0_decim_filter", (3, 18)),
                       ("ap_band_edges", (fs, B)),
                       ("ap_band_masks", (fs, B, n)),
                       ("ap_band_centers", (fs, B)),
                       ("ap_expand_matrix", (fs, B, n // 2 + 1)),
                       ("noise_window", (hop,)), ("noise_ola_norm", (hop,)),
                       ("noise_spec_interp_matrix", (n, hop)),
                       ("noise_band_interp_matrix", (n, hop, fs, B)),
                       ("warp_frequency", (np.linspace(0, 3, 7), 0.466))]:
        np.testing.assert_array_equal(getattr(t_prim, name)(*args),
                                      getattr(j_prim, name)(*args), name)
    for a, b in zip(t_prim.mcep_basis(512, 59, 0.466),
                    j_prim.mcep_basis(512, 59, 0.466)):
        np.testing.assert_array_equal(a, b)
    for name in ("DEFAULT_F0", "SILENCE_POWER", "POWER_FLOOR",
                 "HARMONIC_NYQUIST_FRACTION"):
        assert getattr(t_prim, name) == getattr(j_prim, name)
    assert t_prim.analysis_window_sumsq(n) == j_prim.analysis_window_sumsq(n)
    assert t_prim.noise_fft_size(hop) == j_prim.noise_fft_size(hop)


@pytest.mark.parametrize("n", [1022, 326, 979, 980])
def test_dft_bases_equal_jax(n):
    """979 is the odd frame length of the full-rate F0 search
    (f0_decimation = 1), which once broke the JAX package's bases: both
    packages refuse an odd n for every basis with a Nyquist bin, and the
    search builds its bases at 980 (its frame rounded up to even)."""
    if n % 2:
        for name in ("rfft_bases", "irfft_bases", "cepstrum_basis",
                     "cepstrum_inverse_basis", "autocorr_weights"):
            for dft in (t_dft, j_dft):
                with pytest.raises(AssertionError, match="even n"):
                    getattr(dft, name)(n)
        np.testing.assert_array_equal(t_dft.prefix_sum_matrix(n),
                                      j_dft.prefix_sum_matrix(n))
        return
    for name in ("rfft_bases", "irfft_bases"):
        for a, b in zip(getattr(t_dft, name)(n), getattr(j_dft, name)(n)):
            np.testing.assert_array_equal(a, b)
    for name in ("cepstrum_basis", "cepstrum_inverse_basis",
                 "prefix_sum_matrix", "autocorr_weights"):
        np.testing.assert_array_equal(getattr(t_dft, name)(n),
                                      getattr(j_dft, name)(n), name)


def test_dft_device_ops_match_jax():
    rng = np.random.default_rng(0)
    n = 326
    K = n // 2 + 1
    a = rng.standard_normal((6, n)).astype(np.float32)
    b = rng.standard_normal((6, n)).astype(np.float32)
    L = rng.standard_normal((6, K)).astype(np.float32)
    lift = rng.uniform(0, 1, (6, K)).astype(np.float32)
    lag = rng.uniform(20, 150, 6).astype(np.float32)
    P = np.abs(L)
    pairs = [
        (t_dft.power_spectrum(t32(a), n), j_dft.power_spectrum(a, n)),
        (t_dft.quefrency_filter(t32(L), t32(lift), n),
         j_dft.quefrency_filter(jnp.asarray(L), jnp.asarray(lift), n)),
        (t_dft.irfft_real(t32(L), t32(lift), n, 100),
         j_dft.irfft_real(jnp.asarray(L), jnp.asarray(lift), n, 100)),
        (t_dft.cross_correlation(t32(a), t32(b), n, 120),
         j_dft.cross_correlation(jnp.asarray(a), jnp.asarray(b), n, 120)),
        (t_dft.autocorr_at_lag(t32(P), t32(lag), n),
         j_dft.autocorr_at_lag(jnp.asarray(P), jnp.asarray(lag), n)),
    ]
    for t, j in pairs:
        assert rel_to_peak(t.numpy(), np.asarray(j)) < 1e-5


def test_framing_matches_jax():
    x, F = _signal("sweep", 0.3)
    for frame_len, off in [(CFG.fft_size, 0), (CFG.f0_frame_len, 517),
                           (CFG.hop, -300)]:
        np.testing.assert_array_equal(
            t_fr.extract_centered_frames(t32(x), F, CFG.hop, frame_len,
                                         off).numpy(),
            np.asarray(j_fr.extract_centered_frames(jnp.asarray(x), F,
                                                    CFG.hop, frame_len,
                                                    off)))
    rng = np.random.default_rng(2)
    for K, C in [(512, None), (5, None), (40, 3)]:
        shape = (7, K) if C is None else (7, K, C)
        values = rng.standard_normal(shape).astype(np.float32)
        pos = rng.uniform(-1, K + 1, (7, 30)).astype(np.float32)
        pos[0, :3] = [0.0, K - 1.0, K - 1.5]
        np.testing.assert_array_equal(
            t_fr.lerp_rows(t32(values), t32(pos)).numpy(),
            np.asarray(j_fr.lerp_rows(jnp.asarray(values),
                                      jnp.asarray(pos))))
    raw = rng.uniform(0, 300, (3, 25)).astype(np.float32)
    np.testing.assert_array_equal(
        t_fr.median3(t32(raw), dim=1).numpy(),
        np.asarray(j_fr.median3(jnp.asarray(raw), axis=1)))


def _controls(kind):
    """Synthesis controls [F+1, ...] from the JAX analysis of a signal,
    plus seeded unit gaussians."""
    x, F = _signal(kind)
    feat = j_world.analyze(jnp.asarray(x), F, CFG)
    ext = [np.concatenate([np.asarray(a), np.asarray(a)[-1:]])
           for a in (feat.f0, feat.env, feat.ap)]
    k_noise = j_prim.noise_fft_size(CFG.hop) // 2 + 1
    noise = np.random.default_rng(7).standard_normal(
        (F, k_noise, 2)).astype(np.float32)
    return ext, noise, F


@pytest.mark.parametrize("kind", KINDS)
def test_synthesis_matches_jax(kind):
    (f0, env, ap), noise, F = _controls(kind)
    jw, jc = j_syn.synthesize(jnp.asarray(f0), jnp.asarray(env),
                              jnp.asarray(ap), jnp.asarray(noise), CFG)
    tw, tc = t_syn.synthesize(t32(f0), t32(env), t32(ap), t32(noise), CFG)
    jw = np.asarray(jw)
    assert tw.shape == (F * CFG.hop,)
    # tests/test_dsp_golden.py synthesis tolerances (2e-2 of the peak,
    # tail 1e-3 of the peak, phase on the unit circle 2e-2)
    assert rel_to_peak(tw.numpy(), jw) < 2e-2
    scale = np.abs(jw).max()
    np.testing.assert_allclose(tc.noise_tail.numpy(),
                               np.asarray(jc.noise_tail), rtol=0,
                               atol=1e-3 * scale)
    p_t, p_j = float(tc.phase), float(jc.phase)
    np.testing.assert_allclose([np.sin(p_t), np.cos(p_t)],
                               [np.sin(p_j), np.cos(p_j)], atol=2e-2)
    assert bool(tc.voiced_prev) == bool(jc.voiced_prev)


def test_synthesis_carry_continuity():
    """Chunked synthesis with the carry equals one-shot synthesis."""
    (f0, env, ap), noise, F = _controls("sweep")
    full, _ = t_syn.synthesize(t32(f0), t32(env), t32(ap), t32(noise), CFG)
    half = F // 2
    carry = t_syn.SynthCarry.zeros(CFG, "cpu")
    w1, carry = t_syn.synthesize(t32(f0[: half + 1]), t32(env[: half + 1]),
                                 t32(ap[: half + 1]), t32(noise[:half]), CFG,
                                 carry)
    w2, _ = t_syn.synthesize(t32(f0[half:]), t32(env[half:]),
                             t32(ap[half:]), t32(noise[half:]), CFG, carry)
    chunked = torch.cat([w1, w2]).numpy()
    assert rel_to_peak(chunked, full.numpy()) < 2e-3


def test_integrate_phase_matches_jax():
    rng = np.random.default_rng(4)
    F = 20
    f0f = rng.uniform(80, 400, F + 1).astype(np.float32)
    voiced = rng.uniform(0, 1, F + 1) > 0.3
    for phase, vprev in [(1.3, True), (0.0, False)]:
        jcarry = j_syn.SynthCarry(phase=jnp.asarray(phase, jnp.float32),
                                  voiced_prev=jnp.asarray(vprev),
                                  noise_tail=jnp.zeros(360))
        tcarry = t_syn.SynthCarry(phase=torch.tensor(phase),
                                  voiced_prev=torch.tensor(vprev),
                                  noise_tail=torch.zeros(360))
        jt = j_syn.integrate_phase(jnp.asarray(f0f), jnp.asarray(voiced),
                                   CFG, jcarry)
        tt = t_syn.integrate_phase(t32(f0f), torch.from_numpy(voiced), CFG,
                                   tcarry)
        np.testing.assert_allclose(tt.phi.numpy(), np.asarray(jt.phi),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(tt.adv.numpy(), np.asarray(jt.adv),
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(tt.no_reset.numpy(),
                                      np.asarray(jt.no_reset))
        assert abs(float(tt.phase_out) - float(jt.phase_out)) < 1e-4
        assert bool(tt.vprev_out) == bool(jt.vprev_out)


@pytest.mark.parametrize("kind", KINDS)
def test_envelope_mcep_aperiodicity_match_jax(kind):
    x, F = _signal(kind)
    jx = jnp.asarray(x)
    f0 = np.asarray(j_world.analyze(jx, F, CFG).f0)
    jP = np.asarray(j_env.power_spectrogram(jx, F, CFG))
    tP = t_env.power_spectrogram(t32(x), F, CFG)
    assert rel_to_peak(tP.numpy(), jP) < 1e-4
    jf = j_world.analyze_given_f0(jx, jnp.asarray(f0), F, CFG)
    tf = t_world.analyze_given_f0(t32(x), t32(f0), F, CFG)
    # tests/test_dsp_golden.py gates: log envelope 0.05 within 45 dB of the
    # frame peak (0.17 below), mc 1.2e-2, aperiodicity 2e-2
    lj, lt = np.log(np.asarray(jf.env)), np.log(tf.env.numpy())
    hi = np.asarray(jf.env) >= np.asarray(jf.env).max(
        axis=1, keepdims=True) * 10.0 ** (-45.0 / 10.0)
    assert np.abs(lt - lj)[hi].max() < 0.05
    assert np.abs(lt - lj)[~hi].max() < 0.17
    np.testing.assert_allclose(tf.mc.numpy(), np.asarray(jf.mc), rtol=0,
                               atol=1.2e-2)
    np.testing.assert_allclose(tf.ap.numpy(), np.asarray(jf.ap), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(
        t_ap.band_aperiodicity_from_power(tP, t32(f0), CFG).numpy(),
        np.asarray(j_ap.band_aperiodicity_from_power(jnp.asarray(jP),
                                                     jnp.asarray(f0), CFG)),
        rtol=0, atol=2e-2)
    # mcep encode / decode (test_mcep_roundtrip_matches_golden tolerances)
    env = np.asarray(jf.env)
    mc_j = np.asarray(j_mcep.encode_mcep(jnp.asarray(env), CFG))
    np.testing.assert_allclose(t_mcep.encode_mcep(t32(env), CFG).numpy(),
                               mc_j, rtol=0, atol=5e-3)
    np.testing.assert_allclose(
        np.log(t_mcep.decode_mcep(t32(mc_j), CFG).numpy()),
        np.log(np.asarray(j_mcep.decode_mcep(jnp.asarray(mc_j), CFG))),
        rtol=0, atol=2e-3)


def _f0_agree(t, j):
    """test_dsp_golden.py's F0 gate: voicing agreement > 0.98 and p95
    error < 1 Hz on frames both call voiced."""
    t, j = np.asarray(t), np.asarray(j)
    assert ((t > 0) == (j > 0)).mean() > 0.98
    both = (t > 0) & (j > 0)
    if both.any():
        assert np.percentile(np.abs(t[both] - j[both]), 95) < 1.0


def test_f0_full_rate_matches_jax_and_golden():
    """f0_decimation = 1, the full-rate F0 search with its odd frame length,
    against the jitted JAX estimate_f0 and against the golden model on the
    0.4 s sweep, at tests/test_dsp_golden.py's gate for it."""
    import dataclasses

    import jax

    from realtime_yukarin_tpu.golden import reference as ref
    cfg1 = dataclasses.replace(CFG, f0_decimation=1)
    assert cfg1.f0_frame_len % 2 == 1
    x = make_test_signal("sweep", 0.4, cfg1.sample_rate)
    F = len(x) // cfg1.hop
    t = t_f0.estimate_f0(t32(x), F, cfg1).numpy()
    j = jax.jit(j_f0.estimate_f0, static_argnums=(1, 2))(
        jnp.asarray(x, jnp.float32), F, cfg1)
    g = ref.estimate_f0(x, F, cfg1)
    assert ((t > 0) & (g > 0)).any()
    _f0_agree(t, j)
    _f0_agree(t, g)


@pytest.mark.parametrize("kind", KINDS)
def test_f0_chain_matches_jax(kind):
    x, F = _signal(kind, 0.5)
    jx, tx = jnp.asarray(x), t32(x)
    jraw, jcand, jemis = j_f0.f0_raw_and_candidates(jx, F, CFG)
    traw, tcand, temis = t_f0.f0_raw_and_candidates(tx, F, CFG)
    _f0_agree(traw, jraw)
    # the K slots hold the dips in depth order, so two near-equal dips may
    # swap slots between the two float32 reduction orders: compare each
    # frame's candidates as a set (sorted by F0)
    order_t = np.argsort(tcand.numpy(), axis=1)
    order_j = np.argsort(np.asarray(jcand), axis=1)
    tc_s = np.take_along_axis(tcand.numpy(), order_t, 1)
    jc_s = np.take_along_axis(np.asarray(jcand), order_j, 1)
    te_s = np.take_along_axis(temis.numpy(), order_t, 1)
    je_s = np.take_along_axis(np.asarray(jemis), order_j, 1)
    _f0_agree(tc_s, jc_s)
    # emissions: the same > 0.98 frame-agreement gate as the voicing.  At
    # near-silent onset frames d = e0 + e - 2c cancels in float32 and the
    # two summation orders give different CMND curves (ROADMAP.md
    # "Faults": formant, frame 3)
    valid_t, valid_j = te_s < 0.5 * t_f0._BIG, je_s < 0.5 * t_f0._BIG
    same = (valid_t == valid_j).all(axis=1) & np.all(
        np.abs(np.where(valid_j, te_s - je_s, 0.0)) <= 1e-3, axis=1)
    assert same.mean() > 0.98, np.nonzero(~same)[0]
    # the downstream stages on identical inputs (the JAX values)
    med = np.asarray(j_fr.median3(jraw))
    js, jch = j_f0.viterbi_snap(jnp.asarray(med), jcand, jemis, CFG)
    ts, tch = t_f0.viterbi_snap(t32(med), t32(jcand), t32(jemis), CFG)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tch.numpy(), np.asarray(jch), rtol=0,
                               atol=1e-4)
    P = j_env.power_spectrogram(jx, F, CFG)
    jv = j_f0.voicing_revision(jx, js, jch, F, CFG, 0, P=P)
    tv = t_f0.voicing_revision(tx, t32(js), t32(jch), F, CFG, 0,
                               P=t32(P))
    np.testing.assert_array_equal(tv.numpy() > 0, np.asarray(jv) > 0)
    _f0_agree(tv, jv)
    jr = j_f0.refine_f0_from_power(P, jv, CFG)
    tr = t_f0.refine_f0_from_power(t32(P), t32(jv), CFG)
    np.testing.assert_array_equal(tr.numpy() > 0, np.asarray(jr) > 0)
    _f0_agree(tr, jr)


@pytest.mark.parametrize("kind", KINDS)
def test_analyze_matches_jax(kind):
    x, F = _signal(kind, 0.5)
    jf = j_world.analyze(jnp.asarray(x), F, CFG)
    tf = t_world.analyze(t32(x), F, CFG)
    _f0_agree(tf.f0, jf.f0)
    both = (tf.f0.numpy() > 0) == (np.asarray(jf.f0) > 0)
    np.testing.assert_allclose(tf.mc.numpy()[both], np.asarray(jf.mc)[both],
                               rtol=0, atol=1.2e-2)
    np.testing.assert_allclose(tf.ap.numpy()[both], np.asarray(jf.ap)[both],
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("kind", KINDS)
def test_standalone_entry_points_match_jax(kind):
    """The standalone entry points (estimate_f0, estimate_f0_raw,
    f0_candidates, spectral_envelope, envelope_from_power,
    log_envelope_from_power, band_aperiodicity, expand_aperiodicity)
    against the JAX package's, jitted, at the gates above; estimate_f0 is
    analyze's F0 exactly."""
    import jax
    x, F = _signal(kind, 0.5)
    jx, tx = jnp.asarray(x), t32(x)

    def jit(fn, *static):
        return jax.jit(fn, static_argnums=static)

    jf0 = jit(j_f0.estimate_f0, 1, 2)(jx, F, CFG)
    tf0 = t_f0.estimate_f0(tx, F, CFG)
    _f0_agree(tf0, jf0)
    assert torch.equal(tf0, t_world.analyze(tx, F, CFG).f0)
    _f0_agree(t_f0.estimate_f0_raw(tx, F, CFG),
              jit(j_f0.estimate_f0_raw, 1, 2)(jx, F, CFG))
    tcand, _ = t_f0.f0_candidates(tx, F, CFG)
    jcand, _ = jit(j_f0.f0_candidates, 1, 2)(jx, F, CFG)
    _f0_agree(np.sort(tcand.numpy(), axis=1),
              np.sort(np.asarray(jcand), axis=1))
    f0 = np.asarray(jf0)
    jP = jit(j_env.power_spectrogram, 1, 2)(jx, F, CFG)
    tP = t32(jP)
    for t_env_out, j_env_out in (
            (t_env.spectral_envelope(tx, t32(f0), F, CFG),
             jit(j_env.spectral_envelope, 2, 3)(jx, jnp.asarray(f0), F, CFG)),
            (t_env.envelope_from_power(tP, t32(f0), CFG),
             jit(j_env.envelope_from_power, 2)(jP, jnp.asarray(f0), CFG)),
            (torch.exp(t_env.log_envelope_from_power(tP, t32(f0), CFG)),
             jnp.exp(jit(j_env.log_envelope_from_power, 2)(
                 jP, jnp.asarray(f0), CFG)))):
        lj, lt = np.log(np.asarray(j_env_out)), np.log(t_env_out.numpy())
        hi = np.asarray(j_env_out) >= np.asarray(j_env_out).max(
            axis=1, keepdims=True) * 10.0 ** (-45.0 / 10.0)
        assert np.abs(lt - lj)[hi].max() < 0.05
        assert np.abs(lt - lj)[~hi].max() < 0.17
    jap = jit(j_ap.band_aperiodicity, 2, 3)(jx, jnp.asarray(f0), F, CFG)
    np.testing.assert_allclose(
        t_ap.band_aperiodicity(tx, t32(f0), F, CFG).numpy(), np.asarray(jap),
        rtol=0, atol=2e-2)
    np.testing.assert_allclose(
        t_ap.expand_aperiodicity(t32(jap), CFG).numpy(),
        np.asarray(jit(j_ap.expand_aperiodicity, 1)(jap, CFG)), rtol=0,
        atol=1e-6)
