"""Synthetic paired-speaker data for training (PyTorch port of the
synthetic-pair part of ``training/data.py``).

A "source speaker" harmonic+noise utterance and a "target speaker" version
with another F0 and spectral tilt, analysed by the port's ``dsp/world.py``
on the given device (on the card: the power-spectrum and envelope-cepstrum
kernels).  The waveforms and the renderer's noise come from one numpy
generator drawn in the JAX package's order, so both packages see the same
samples bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.dsp.world import analyze
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


def make_batch(cfg: Config, batch_size: int, seconds: float = 0.5,
               seed: int = 0, f0_ratio: float = 1.4, tilt_src: float = 0.1,
               tilt_tgt: float = 0.3, device=None) -> Batch:
    """Analyse ``batch_size`` seeded source/target pairs into a training
    Batch on ``device`` (``cuda`` unless the caller names another)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    fs = cfg.dsp.sample_rate
    hop = cfg.dsp.hop
    F = int(seconds * fs) // hop
    k_noise = prim.noise_fft_size(hop) // 2 + 1

    def ext(a):
        return torch.cat([a, a[-1:]])

    src_f = {"f0": [], "mc": [], "ap": []}
    tgt_f = {"f0": [], "mc": [], "env": [], "ap": []}
    waves = []
    for _ in range(batch_size):
        base = rng.uniform(110, 220)
        src = synth_utterance(rng, seconds, fs, base, tilt_src)
        tgt = synth_utterance(rng, seconds, fs, base * f0_ratio, tilt_tgt)
        fs_feat = analyze(torch.from_numpy(src[: F * hop]).to(device), F,
                          cfg.dsp)
        ft_feat = analyze(torch.from_numpy(tgt[: F * hop]).to(device), F,
                          cfg.dsp)
        for k in src_f:
            src_f[k].append(ext(getattr(fs_feat, k)))
        for k in tgt_f:
            tgt_f[k].append(ext(getattr(ft_feat, k)))
        waves.append(tgt[: F * hop])

    noise = rng.standard_normal((batch_size, F, k_noise, 2)).astype(
        np.float32)
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
        wave_voc=torch.from_numpy(np.stack(waves)).to(device),
        noise=torch.from_numpy(noise).to(device))
