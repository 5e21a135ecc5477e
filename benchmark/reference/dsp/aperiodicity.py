"""Band aperiodicity — D4C role (PyTorch port of ``dsp/aperiodicity.py``).

Normalized lag-domain periodicity of each band at the per-frame F0 lag,
straight from the band-masked shared power spectrogram (Wiener-Khinchin),
window-ACF-corrected:  p_b = r_b(lag) / (r_b(0) * hann_acf(lag)),
ap_b = sqrt(1 - p_b).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.config import DspConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.envelope import power_spectrogram
from benchmark.reference.ops import dft


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


def band_aperiodicity(x: torch.Tensor, f0: torch.Tensor, num_frames: int,
                      cfg: DspConfig, center_offset: int = 0
                      ) -> torch.Tensor:
    """x [..., T], f0 [..., F] -> band aperiodicity [..., F, B] in (0, 1]
    from its own power spectrogram (``dsp/world.py`` shares the
    envelope's instead)."""
    P = power_spectrogram(x, num_frames, cfg, center_offset)
    return band_aperiodicity_from_power(P, f0, cfg)


def expand_aperiodicity(ap: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """[..., B] band values -> [..., K] per-bin values (linear in
    frequency)."""
    W = dft.device_const(prim.ap_expand_matrix, cfg.sample_rate,
                         cfg.num_ap_bands, cfg.spec_bins, like=ap)
    return ap @ W.T
