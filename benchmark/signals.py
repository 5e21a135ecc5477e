"""Speech-like input signals from the seed, made on the device.

Each signal follows the test signal the program's own smoke checks use: a
vibrato harmonic stack to 0.9 of Nyquist at -6 dB per octave with
amplitude modulation, 0.4 s segments cycling voiced, voiced, a louder
noise burst and the noise floor alone (-34 dB), normalised to a peak of
0.5 and scaled by the signal's gain.  A full harmonic stack over a noise
floor keeps the envelope's bins off its -70 dB floor, where two float32
orders of summation would part.  Signal i has its own f0 scale and gain
(evenly spread over the given ranges, in an order drawn from the seed),
its own vibrato phase and segment offset, and its own noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HARMONICS = 79


def speech_pool(n: int, seconds: float, fs: int, seed: int, device,
                f0_scale=(0.8, 1.2), gain=(0.3, 1.7)) -> np.ndarray:
    """[n, seconds * fs] float32 host array."""
    L = int(round(seconds * fs))
    gen = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(n, generator=gen, device=device).cpu().numpy()
    share = (order + 0.5) / n
    scales = torch.tensor(f0_scale[0] + (f0_scale[1] - f0_scale[0]) * share,
                          dtype=torch.float64, device=device)
    gains = torch.tensor(gain[0] + (gain[1] - gain[0]) * share[::-1].copy(),
                         dtype=torch.float64, device=device)
    u = torch.rand((n, 2), generator=gen, device=device,
                   dtype=torch.float64)
    t = torch.arange(L, dtype=torch.float64, device=device) / fs
    f0 = scales[:, None] * (140.0 + 40.0 * torch.sin(
        2 * math.pi * (1.3 * t[None] + u[:, :1])))
    ph = 2 * math.pi * torch.cumsum(f0, dim=1) / fs
    k_max = torch.floor(0.9 * fs / 2 / f0)
    voiced = torch.zeros((n, L), dtype=torch.float64, device=device)
    for k in range(1, HARMONICS + 1):
        voiced += torch.where(k <= k_max, torch.sin(k * ph) / k, 0.0)
    seg = torch.floor(t[None] * 2.5 + 4 * u[:, 1:]).long() % 4
    am = 0.3 + 0.1 * torch.sin(2 * math.pi * 3.0 * t)[None]
    noise = torch.randn((n, L), generator=gen, device=device,
                        dtype=torch.float64)
    floor = torch.randn((n, L), generator=gen, device=device,
                        dtype=torch.float64)
    x = torch.where(seg < 2, am * voiced, 0.0)
    x = x + torch.where(seg == 2, 0.1 * noise, 0.0) + 0.01 * floor
    x = 0.5 * x / x.abs().amax(dim=1, keepdim=True) * gains[:, None]
    return x.float().cpu().numpy()
