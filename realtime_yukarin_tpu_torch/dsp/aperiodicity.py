"""Band aperiodicity — D4C role (PyTorch port of ``dsp/aperiodicity.py``).

Normalized lag-domain periodicity of each band at the per-frame F0 lag,
straight from the band-masked shared power spectrogram (Wiener-Khinchin),
window-ACF-corrected:  p_b = r_b(lag) / (r_b(0) * hann_acf(lag)),
ap_b = sqrt(1 - p_b).
"""

from __future__ import annotations

import math

import torch

from realtime_yukarin_tpu_torch.config import DspConfig
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.ops import dft


def band_aperiodicity_from_power(P: torch.Tensor, f0: torch.Tensor,
                                 cfg: DspConfig) -> torch.Tensor:
    """Hann-windowed power spectrogram [..., F, K] + f0 [..., F] -> ap
    [..., F, B]."""
    N = cfg.fft_size
    B = cfg.num_ap_bands
    fs = float(cfg.sample_rate)
    masks = dft.device_const(prim.ap_band_masks, cfg.sample_rate, B, N,
                             like=P)                          # [B, K]
    w = dft.device_const(dft.autocorr_weights, N, like=P)     # [K]

    lag = torch.clamp(torch.round(fs / torch.clamp(f0, min=1.0)),
                      cfg.lag_min, cfg.lag_max)               # [..., F]
    K = P.shape[-1]
    k = torch.arange(K, dtype=P.dtype, device=P.device)
    cosv = torch.cos((2.0 * math.pi / N) * lag[..., None] * k)  # [.., F, K]
    rho = (2.0 + torch.cos(2.0 * math.pi * lag / N)) / 3.0    # [F]

    Pw = P * w                                                # [F, K]
    r_lag = (Pw * cosv) @ masks.T
    r0 = Pw @ masks.T
    p = r_lag / (r0 + 1e-20) / rho[..., None]
    ap = torch.sqrt(torch.clamp(1.0 - p, 1e-6, 1.0))
    return torch.where((f0 > 0)[..., None], ap, torch.ones_like(ap))
