"""A seeded parallel corpus: pairs of formant-synthesised utterances of two
speakers saying the same thing, written as 16-bit mono WAVs.

An utterance is a glottal pulse train with jitter and shimmer through three
Klatt-style resonators, with voiced gaps and an aspiration floor (the
program's own test corpus uses the same construction).  Its structure
(vowel, gate timing, vibrato rate) comes from the pair's structure seed, so
both speakers of a pair say the "same sentence" for the alignment; its
sample-level detail comes from the corpus generator.  The source speaker
is 140 Hz with a neutral tract and bright tilt; the target 200 Hz with a
shorter tract (0.8), a darker tilt and a -22 dB inharmonic partial at
1.62 f0 that a harmonic-plus-noise renderer cannot produce.
"""

from __future__ import annotations

import pathlib
import wave

import numpy as np

SRC_SPEAKER = dict(f0_base=140.0, formant_scale=1.0, tilt=0.1)
TGT_SPEAKER = dict(f0_base=200.0, formant_scale=0.8, tilt=0.5,
                   inharmonic=0.08)


def formant_utterance(structure_seed: int, rng: np.random.Generator,
                      seconds: float, fs: int, f0_base: float = 150.0,
                      formant_scale: float = 1.0, tilt: float = 0.1,
                      inharmonic: float = 0.0) -> np.ndarray:
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


def write_wav(path, x: np.ndarray, rate: int) -> None:
    """float32 mono -> 16-bit PCM (clipped to [-1, 1])."""
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def formant_pairs(root: pathlib.Path, spec: dict, fs: int, seed_entropy
                  ) -> list[tuple[pathlib.Path, pathlib.Path]]:
    """``spec["pairs"]`` pairs under ``root/src`` and ``root/tgt`` (same
    stems, ``utt00`` ...): the source lasts an even spread over
    ``spec["seconds"]`` (shuffled by the seed), the target ``spec[
    "target_ratio"]`` times as long.  Returns the (source, target)
    paths in stem order."""
    rng = np.random.default_rng(seed_entropy)
    n = int(spec["pairs"])
    lo, hi = spec["seconds"]
    lengths = rng.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
    structure = rng.integers(0, 2 ** 31, n)
    out = []
    for d in ("src", "tgt"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for k in range(n):
        s, t = (root / d / f"utt{k:02d}.wav" for d in ("src", "tgt"))
        sec = float(lengths[k])
        write_wav(s, formant_utterance(int(structure[k]), rng, sec, fs,
                                       **SRC_SPEAKER), fs)
        write_wav(t, formant_utterance(int(structure[k]), rng,
                                       sec * spec["target_ratio"], fs,
                                       **TGT_SPEAKER), fs)
        out.append((s, t))
    return out
