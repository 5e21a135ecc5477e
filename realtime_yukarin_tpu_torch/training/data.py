"""Synthetic paired-speaker data for training (PyTorch port of
``training/data.py``).

Two kinds of pairs.  ``make_batch``: a "source speaker" harmonic+noise
utterance and a "target speaker" version with another F0 and spectral
tilt, analysed by the port's ``dsp/world.py`` on the given device (on the
card: the power-spectrum and envelope-cepstrum kernels, inside the
analysis program of ``pipeline.offline_analyze``).  The formant
corpus (``formant_utterance``, ``build_formant_corpus``): formant-
synthesised two-speaker WAVs, prepared by ``training/corpus.py``.  Every
waveform and the renderer's noise come from numpy generators drawn in the
JAX package's order, so both packages see the same samples bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.pipeline import offline_analyze
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.train_step import Batch


def synth_utterance(rng: np.random.Generator, seconds: float, fs: int,
                    f0_base: float, tilt: float) -> np.ndarray:
    """Randomized harmonic+noise utterance with voiced/unvoiced segments."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = f0_base * (1.0 + 0.15 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                    + 0.05 * rng.standard_normal())
    ph = 2 * np.pi * np.cumsum(f0) / fs
    gate = (np.sin(2 * np.pi * rng.uniform(0.5, 1.5) * t
                   + rng.uniform(0, 6)) > -0.4).astype(float)
    x = np.zeros(n)
    for h in range(1, 9):
        amp = (1.0 / h) * np.exp(-tilt * h)
        x += amp * np.sin(h * ph)
    am = 0.25 + 0.15 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    return (gate * am * x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def formant_utterance(structure_seed: int, rng: np.random.Generator,
                      seconds: float, fs: int, f0_base: float = 150.0,
                      formant_scale: float = 1.0, tilt: float = 0.1,
                      inharmonic: float = 0.0) -> np.ndarray:
    """Formant-synthesised utterance: a glottal pulse train with jitter
    and shimmer through three Klatt-style resonators, with voiced gaps and
    an aspiration floor.

    Speaker identity is (f0_base, formant_scale, tilt, inharmonic):
    formant_scale models vocal-tract length, tilt the glottal spectral
    slope; ``inharmonic`` adds a non-harmonic partial at 1.62·f0, which a
    harmonic+noise renderer cannot produce and the neural vocoders must
    learn from the real waveform.  The segmental structure (vowel, gate
    timing, vibrato rate) comes from ``structure_seed``, so a pair built
    with one seed is the "same sentence" for DTW; sample-level detail
    (jitter, shimmer, noise) comes from ``rng``.
    """
    from scipy.signal import lfilter
    srng = np.random.default_rng(structure_seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    vowels = ((730.0, 1090.0, 2440.0), (270.0, 2290.0, 3010.0),
              (570.0, 840.0, 2410.0), (440.0, 1020.0, 2240.0))
    F123 = np.asarray(vowels[int(srng.integers(len(vowels)))])
    F123 = F123 * formant_scale
    gate_f, gate_ph = srng.uniform(0.5, 1.5), srng.uniform(0, 6)
    vib = srng.uniform(3.0, 6.0)

    gate = (np.sin(2 * np.pi * gate_f * t + gate_ph) > -0.4).astype(float)
    k = np.exp(-1.0 / (0.004 * fs))
    jit = lfilter([1 - k], [1, -k], rng.standard_normal(n))
    f0 = f0_base * (1.0 + 0.02 * np.sin(2 * np.pi * vib * t)) \
        * (1.0 + 0.05 * jit)
    phase = np.cumsum(f0 * gate) / fs
    pulses = np.diff(np.floor(phase), prepend=0.0) > 0
    src = np.zeros(n)
    idx = np.nonzero(pulses)[0]
    src[idx] = 1.0 + 0.08 * rng.standard_normal(len(idx))
    src += 0.015 * rng.standard_normal(n) * gate      # aspiration

    y = np.zeros(n)
    bws = (90.0, 110.0, 150.0)
    for i, (Fi, bw) in enumerate(zip(F123, bws)):
        r = np.exp(-np.pi * bw / fs)
        a1, a2 = 2 * r * np.cos(2 * np.pi * Fi / fs), -r * r
        w = (1.0, 0.7, 0.4)[i] * np.exp(-tilt * (i + 1))
        y += w * lfilter([1.0 - r], [1.0, -a1, -a2], src)
    y += 0.02 * rng.standard_normal(n)                # unvoiced floor
    y = 0.4 * y / (np.abs(y).max() + 1e-9)
    if inharmonic:
        ph = 2 * np.pi * np.cumsum(1.62 * f0 * gate) / fs
        y = y + inharmonic * 0.4 * np.sin(ph) * gate
    return y.astype(np.float32)


# source speaker: 140 Hz, neutral tract, bright tilt; target: 200 Hz,
# shorter tract (0.8), darker tilt, a -22 dB inharmonic partial, 10% slower
SRC_SPEAKER = dict(f0_base=140.0, formant_scale=1.0, tilt=0.1)
TGT_SPEAKER = dict(f0_base=200.0, formant_scale=0.8, tilt=0.5,
                   inharmonic=0.08)

# build_formant_corpus: source / target seconds of every pair, and the
# bucket its corpus is prepared at
FORMANT_SECONDS = (0.6, 0.66)
FORMANT_BUCKET = 32


def build_formant_corpus(root, cfg: Config, n_train: int = 6,
                         seed: int = 3, heldout_seed: int = 100,
                         verbose: bool = False, device=None) -> dict:
    """Write and prepare (on ``device``, ``cuda`` unless the caller names
    another) the two-speaker formant corpus of the held-out training
    gates and the quality tool: ``n_train`` pairs of 0.6 s / 0.66 s and
    one held-out pair, the WAVs byte-identical to the JAX package's (the
    rng consumption order is fixed).

    Returns {"src","tgt","ev_src","ev_tgt","prep_tr","prep_ev"} paths;
    ``prep_tr`` / ``prep_ev`` hold the prepared npz pairs + F0 stats."""
    import pathlib

    from realtime_yukarin_tpu_torch.training.corpus import prepare_corpus
    from realtime_yukarin_tpu_torch.utils.audio_io import write_wav

    device = resolve_device(device)
    root = pathlib.Path(root)
    dirs = {n: root / n for n in
            ("src", "tgt", "ev_src", "ev_tgt", "prep_tr", "prep_ev")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    fs = cfg.dsp.sample_rate
    s_src, s_tgt = FORMANT_SECONDS
    for k in range(n_train):
        write_wav(str(dirs["src"] / f"utt{k}.wav"),
                  formant_utterance(k, rng, s_src, fs, **SRC_SPEAKER), fs)
        write_wav(str(dirs["tgt"] / f"utt{k}.wav"),
                  formant_utterance(k, rng, s_tgt, fs, **TGT_SPEAKER), fs)
    write_wav(str(dirs["ev_src"] / "ho.wav"),
              formant_utterance(heldout_seed, rng, s_src, fs, **SRC_SPEAKER),
              fs)
    write_wav(str(dirs["ev_tgt"] / "ho.wav"),
              formant_utterance(heldout_seed, rng, s_tgt, fs, **TGT_SPEAKER),
              fs)
    for src, tgt, prep in (("src", "tgt", "prep_tr"),
                           ("ev_src", "ev_tgt", "prep_ev")):
        prepare_corpus(str(dirs[src]), str(dirs[tgt]), str(dirs[prep]),
                       cfg, bucket_frames=FORMANT_BUCKET, verbose=verbose,
                       device=device)
    return dirs


def synth_batch(cfg: Config, batch_size: int, seconds: float = 0.5,
                seed: int = 0, f0_ratio: float = 1.4, tilt_src: float = 0.1,
                tilt_tgt: float = 0.3
                ) -> tuple[list[np.ndarray], list[np.ndarray], np.ndarray]:
    """The host half of :func:`make_batch`: ``batch_size`` seeded
    source/target utterances cut to F whole frames, and the renderer's
    noise [B, F, k_noise, 2], drawn in the JAX package's order."""
    rng = np.random.default_rng(seed)
    fs = cfg.dsp.sample_rate
    hop = cfg.dsp.hop
    F = int(seconds * fs) // hop
    k_noise = prim.noise_fft_size(hop) // 2 + 1
    srcs, tgts = [], []
    for _ in range(batch_size):
        base = rng.uniform(110, 220)
        srcs.append(synth_utterance(rng, seconds, fs, base, tilt_src)[
            : F * hop])
        tgts.append(synth_utterance(rng, seconds, fs, base * f0_ratio,
                                    tilt_tgt)[: F * hop])
    noise = rng.standard_normal((batch_size, F, k_noise, 2)).astype(
        np.float32)
    return srcs, tgts, noise


def analyze_batch(cfg: Config, srcs: list[np.ndarray],
                  tgts: list[np.ndarray], noise: np.ndarray,
                  device=None) -> Batch:
    """The device half of :func:`make_batch`: each utterance analysed by
    :func:`~realtime_yukarin_tpu_torch.pipeline.offline_analyze` (all of
    one length: one program, replayed 2·B times), stacked into a Batch on
    ``device``."""
    device = resolve_device(device)
    F = noise.shape[1]

    def ext(a):
        return torch.cat([a, a[-1:]])

    src_f = {"f0": [], "mc": [], "ap": []}
    tgt_f = {"f0": [], "mc": [], "env": [], "ap": []}
    for src, tgt in zip(srcs, tgts):
        fs_feat = offline_analyze(torch.from_numpy(src), cfg, F, device)
        ft_feat = offline_analyze(torch.from_numpy(tgt), cfg, F, device)
        for k in src_f:
            src_f[k].append(ext(getattr(fs_feat, k)))
        for k in tgt_f:
            tgt_f[k].append(ext(getattr(ft_feat, k)))
    src_f = {k: torch.stack(v) for k, v in src_f.items()}
    tgt_f = {k: torch.stack(v) for k, v in tgt_f.items()}
    # self-vocoding rows coincide with the target utterance's own features
    # here (synthetic pairs share one timeline); wave_voc is the REAL
    # target waveform, never a render
    return Batch(
        f0_src=src_f["f0"], mc_src=src_f["mc"], ap_src=src_f["ap"],
        f0_tgt=tgt_f["f0"], mc_tgt=tgt_f["mc"], env_tgt=tgt_f["env"],
        f0_voc=tgt_f["f0"], mc_voc=tgt_f["mc"], ap_voc=tgt_f["ap"],
        env_voc=tgt_f["env"],
        wave_voc=torch.from_numpy(np.stack(tgts)).to(device),
        noise=torch.from_numpy(noise).to(device))


def make_batch(cfg: Config, batch_size: int, seconds: float = 0.5,
               seed: int = 0, f0_ratio: float = 1.4, tilt_src: float = 0.1,
               tilt_tgt: float = 0.3, device=None) -> Batch:
    """Analyse ``batch_size`` seeded source/target pairs into a training
    Batch on ``device`` (``cuda`` unless the caller names another):
    :func:`synth_batch` on the host, then :func:`analyze_batch`."""
    device = resolve_device(device)
    return analyze_batch(cfg, *synth_batch(cfg, batch_size, seconds, seed,
                                           f0_ratio, tilt_src, tilt_tgt),
                         device=device)
