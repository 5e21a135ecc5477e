"""Spectral envelope estimation — CheapTrick-role (PyTorch port of
``dsp/envelope.py``).

A fixed Hann window feeds an f0-adaptive linear-domain rectangular
smoothing (full width = one harmonic spacing) and an f0-adaptive cepstral
sinc lifter.  The power spectrum and the whole quefrency chain are the two
CUDA kernels of ``ops/analysis.py`` on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.config import DspConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.framing import extract_centered_frames
from benchmark.reference.ops import dft
from benchmark.reference.ops.analysis import (envelope_cepstrum_fused,
                                                     power_spectrum_fused)


def _bins_from_2(n: int) -> np.ndarray:
    return (np.arange(n // 2 + 1) >= 2).astype(np.float64)


def power_spectrogram(x: torch.Tensor, num_frames: int, cfg: DspConfig,
                      center_offset: int = 0) -> torch.Tensor:
    """[..., T] -> |STFT|^2 [..., F, K], Hann window, frames centered at
    i*hop.

    The frame mean is removed first (f32 conditioning under a DC offset)
    and bins 0-1 are zeroed after: a periodic Hann window puts a constant
    input component exactly there, so every downstream stage is DC-
    invariant.  The frames of every leading index go to the power-spectrum
    kernel as one contiguous [rows, N] tensor: one launch for a batch of
    streams.  Compute P once per step and pass it down."""
    N = cfg.fft_size
    frames = extract_centered_frames(x, num_frames, cfg.hop, N,
                                     center_offset)
    lead = frames.shape[:-1]
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    P = power_spectrum_fused(frames.reshape(-1, N).contiguous(), N)
    P = P * dft.device_const(_bins_from_2, N, like=P)
    return P.reshape(*lead, P.shape[-1])


@functools.lru_cache(maxsize=None)
def _folded_mcep_basis(n: int, spec_bins: int, order: int,
                       alpha: float) -> np.ndarray:
    """[Q, M+1] float64: inverse-cepstrum basis folded into the mcep fit,
    so mc projects straight from the lifted half cepstrum."""
    assert spec_bins == n // 2 + 1, (spec_bins, n)
    D = dft.cepstrum_inverse_basis(n)                   # [Q, K]
    _, A = prim.mcep_basis(spec_bins, order, alpha)     # [M+1, K]
    return D @ A.T                                      # [Q, M+1]


def _quefrency_times(n: int, fs: float) -> np.ndarray:
    return np.arange(n // 2 + 1) / fs


def _lifted_half_cepstrum(P: torch.Tensor, f0: torch.Tensor, cfg: DspConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(c [..., F, Q] lifted half cepstrum of the log envelope, lift_half):
    pitch-adaptive linear-domain smoothing, per-frame relative floor, log,
    cepstrum + lifter — one CUDA kernel on the card, launched once over the
    frames of every leading index."""
    N = cfg.fft_size
    fs = float(cfg.sample_rate)
    f0_eff = torch.where(f0 > 0, f0, torch.full_like(f0, prim.DEFAULT_F0))
    t_q = dft.device_const(_quefrency_times, N, fs, like=P)
    lift_half = torch.sinc(f0_eff[..., None] * t_q)
    K = P.shape[-1]
    c = envelope_cepstrum_fused(P.reshape(-1, K).contiguous(),
                                lift_half.reshape(-1, t_q.shape[0]), N,
                                cfg.envelope_floor_db)
    return c.reshape(*P.shape[:-1], c.shape[-1]), lift_half


def log_envelope_and_mcep(P: torch.Tensor, f0: torch.Tensor, cfg: DspConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(LOG power envelope [..., F, K], mel-cepstrum [..., F, M+1]) from the
    shared
    lifted half cepstrum; mc uses the folded basis."""
    N = cfg.fft_size
    c, _ = _lifted_half_cepstrum(P, f0, cfg)
    D = dft.device_const(dft.cepstrum_inverse_basis, N, like=c)
    E = dft.device_const(_folded_mcep_basis, N, cfg.spec_bins,
                         cfg.mcep_order, cfg.mcep_alpha, like=c)
    return c @ D, c @ E


def log_envelope_from_power(P: torch.Tensor, f0: torch.Tensor,
                            cfg: DspConfig) -> torch.Tensor:
    """Power spectrogram [..., F, K] + f0 [..., F] -> LOG power envelope
    [..., F, K] (what the mel-cepstrum encode consumes)."""
    c, _ = _lifted_half_cepstrum(P, f0, cfg)
    return c @ dft.device_const(dft.cepstrum_inverse_basis, cfg.fft_size,
                                like=c)


def envelope_from_power(P: torch.Tensor, f0: torch.Tensor, cfg: DspConfig
                        ) -> torch.Tensor:
    """Power spectrogram [..., F, K] + f0 [..., F] -> power envelope."""
    return torch.exp(log_envelope_from_power(P, f0, cfg))


def spectral_envelope(x: torch.Tensor, f0: torch.Tensor, num_frames: int,
                      cfg: DspConfig, center_offset: int = 0
                      ) -> torch.Tensor:
    """x [..., T] + f0 [..., F] -> power envelope [..., F, K]."""
    return envelope_from_power(
        power_spectrogram(x, num_frames, cfg, center_offset), f0, cfg)
