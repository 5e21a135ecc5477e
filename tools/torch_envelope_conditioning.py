#!/usr/bin/env python3
"""How far float32 rounding moves the port's mel-cepstrum, on the CPU.

    python3 tools/torch_envelope_conditioning.py

For two seeded test signals it runs the envelope chain of the streaming
step (Hann power spectrum, quefrency smoothing, -70 dB relative floor, log,
lifted cepstrum, folded mcep projection; the plain PyTorch versions of the
port's two analysis kernels) three ways: float64, float32 over all frames at
once, and float32 one frame at a time (another order of summation).  It
prints the largest mc difference relative to the largest |mc|.  A large
value means two float32 implementations (the CUDA kernels and the CPU plain
versions, or the port and the JAX package) can differ by that much on the
signal.  Signals: chip_smoke.py's (a harmonic stack to 0.9 of Nyquist over a
-34 dB floor), a narrow one (11 harmonics over a -44 dB floor), and
chip_smoke.py's as a 16 kHz client delivers it (through the port's resample
plans to 16 kHz and back: the band above 8 kHz is empty), at the default
-70 dB envelope floor and at -50 dB.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def narrow_signal(seconds: float, fs: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    ph = 2 * np.pi * np.cumsum(140 + 40 * np.sin(2 * np.pi * 1.3 * t)) / fs
    voiced = sum(np.sin(k * ph) / k for k in range(1, 12))
    seg = (t * 2.5).astype(int) % 4
    am = 0.3 + 0.1 * np.sin(2 * np.pi * 3.0 * t)
    x = np.where(seg < 2, am * voiced, 0.0)
    x = x + np.where(seg == 2, 0.1 * rng.standard_normal(len(t)), 0.0)
    x = x + 0.003 * rng.standard_normal(len(t))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def mc_of(x, f0, cfg, dtype, row_by_row: bool):
    import torch
    from realtime_yukarin_tpu_torch.dsp import envelope, framing
    from realtime_yukarin_tpu_torch.ops import analysis, dft
    n = cfg.fft_size
    xx = torch.from_numpy(x).to(dtype)
    frames = framing.extract_centered_frames(xx, len(f0), cfg.hop, n)
    frames = (frames - frames.mean(-1, keepdim=True)).contiguous()
    P = analysis.power_spectrum_plain(frames, n) * dft.device_const(
        envelope._bins_from_2, n, like=frames)[None]
    f = torch.from_numpy(f0).to(dtype)
    f_eff = torch.where(f > 0, f, torch.full_like(f, 180.0))
    t_q = dft.device_const(envelope._quefrency_times, n,
                           float(cfg.sample_rate), like=P)
    lift = torch.sinc(f_eff[:, None] * t_q[None])
    db = cfg.envelope_floor_db
    if row_by_row:
        c = torch.cat([analysis.envelope_cepstrum_plain(
            P[i:i + 1], lift[i:i + 1], n, db) for i in range(len(f0))])
    else:
        c = analysis.envelope_cepstrum_plain(P, lift, n, db)
    E = dft.device_const(envelope._folded_mcep_basis, n, cfg.spec_bins,
                         cfg.mcep_order, cfg.mcep_alpha, like=c)
    return (c @ E).double()


def main() -> int:
    import torch

    import chip_smoke
    from realtime_yukarin_tpu_torch.config import DspConfig
    from realtime_yukarin_tpu_torch.dsp.world import analyze

    from realtime_yukarin_tpu_torch.dsp import resample as rs

    cfg = DspConfig()
    fs = cfg.sample_rate
    full = chip_smoke.test_signal(1.0, fs, 0)
    down = rs.resample_signal(torch.from_numpy(full),
                              rs.make_plan(fs, 16000, 2400))
    band = rs.resample_signal(down, rs.make_plan(16000, fs, 1600)).numpy()
    floor50 = dataclasses.replace(cfg, envelope_floor_db=-50.0)
    for label, x, cfg in (
            ("chip_smoke signal", full, cfg),
            ("narrow signal", narrow_signal(1.0, fs, 0), cfg),
            ("16 kHz client, -70 dB floor", band, cfg),
            ("16 kHz client, -50 dB floor", band, floor50)):
        F = len(x) // cfg.hop
        f0 = analyze(torch.from_numpy(x), F, cfg).f0.numpy()
        m64 = mc_of(x, f0, cfg, torch.float64, False)
        m32 = mc_of(x, f0, cfg, torch.float32, False)
        m32r = mc_of(x, f0, cfg, torch.float32, True)
        peak = float(m64.abs().max())
        print(f"[conditioning] {label}: max |mc| {peak:.3f}; float32 vs "
              f"float64 {float((m32 - m64).abs().max()) / peak:.2e}; "
              f"float32 batched vs row by row "
              f"{float((m32 - m32r).abs().max()) / peak:.2e} (of the peak)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
