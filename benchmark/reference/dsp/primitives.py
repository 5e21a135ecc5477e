"""Shared DSP constants and precomputed bases (host-side NumPy).

A copy of ``realtime_yukarin_tpu/dsp/primitives.py`` for the PyTorch port
(which imports nothing of the JAX package; ``tests/test_torch_dsp.py``
holds every basis equal to the JAX package's):
windows, mel-style warped cosine bases for the mel-cepstrum, aperiodicity
band masks, and the amplitude conventions of the harmonic+noise synthesizer.

Reference parity notes (SURVEY.md §2b, the WORLD vocoder row): the upstream
reference delegates these to ``mmorise/World`` C++ (CheapTrick liftering,
D4C band aperiodicity, SPTK-style mel-cepstrum).  Here they are re-derived
as *static matrices* so the per-frame work on TPU is pure matmul/elementwise
— the MXU-friendly formulation (SURVEY.md §7 steps 2-3).
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference.config import DspConfig

# Default F0 used for envelope liftering on unvoiced frames (CheapTrick-style
# behavior: unvoiced frames still get a smoothed envelope).
DEFAULT_F0 = 180.0

# Absolute mean-power silence floor for the voicing decision.  The real
# voicing evidence is the scale-invariant CMND periodicity (exact digital
# silence yields d' = 1 everywhere and is unvoiced regardless of this
# floor); the absolute floor only fences out float32 rounding garbage at
# denormal-ish levels, so it sits far below any plausible signal.
# Measured operating range (tests/test_robustness.py, formant fixture —
# a peaky source with ~42 dB crest factor): analysis is unchanged from
# x10 down to x0.01 input gain (voiced mean power ~8e-10 at x0.01) and
# still tracks at x0.001 (~8e-12); the old 1e-9 floor silenced the
# fixture below x0.1 gain (VERDICT r4 missing #1).
SILENCE_POWER = 1e-12

# Absolute power floor applied before log() in envelope estimation.
POWER_FLOOR = 1e-12

# Fraction of Nyquist above which harmonics are masked out (anti-aliasing).
# Defined in config (DspConfig.num_harmonics derives from it); re-exported
# here for the DSP/golden call sites.
from benchmark.reference.config import \
    HARMONIC_NYQUIST_FRACTION  # noqa: E402,F401


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (matches typical STFT usage)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float64)


@functools.lru_cache(maxsize=None)
def f0_decim_filter(decim: int, half_width: int, rolloff: float = 0.9,
                    beta: float = 8.0) -> np.ndarray:
    """Anti-alias FIR for the F0 stage's decimation (WORLD's Dio
    low-passes + downsamples before period search, upstream:mmorise/World
    src/dio.cpp role).  Kaiser-windowed sinc, cutoff rolloff*(fs/2/decim),
    support [-half_width, half_width] full-rate samples, unit DC gain.
    Shared verbatim by the golden and JAX estimators."""
    if decim == 1:
        return np.ones(1, np.float64)
    k = np.arange(-half_width, half_width + 1, dtype=np.float64)
    nu = rolloff / (2.0 * decim)          # cutoff / fs
    h = 2.0 * nu * np.sinc(2.0 * nu * k)
    h *= np.i0(beta * np.sqrt(np.maximum(
        0.0, 1.0 - (k / half_width) ** 2))) / np.i0(beta)
    return h / h.sum()


# ---------------------------------------------------------------------------
# Mel-cepstrum: warped cosine basis.
#
# log-envelope(omega_k) ~= sum_m mc[m] * cos(m * warp(omega_k))
# with the first-order all-pass warping  warp(w) = w + 2*atan(a*sin w /
# (1 - a*cos w)).  encode = least-squares fit (pinv), decode = the basis
# matmul itself.  Both are single matmuls on device.
# ---------------------------------------------------------------------------

def warp_frequency(omega: np.ndarray, alpha: float) -> np.ndarray:
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                    1.0 - alpha * np.cos(omega))


@functools.lru_cache(maxsize=None)
def mcep_basis(spec_bins: int, order: int, alpha: float):
    """Returns (decode_B [K, order+1], encode_A [order+1, K]) float64."""
    omega = np.pi * np.arange(spec_bins) / (spec_bins - 1)
    warped = warp_frequency(omega, alpha)
    m = np.arange(order + 1)
    B = np.cos(np.outer(warped, m))            # [K, M+1]
    A = np.linalg.pinv(B)                      # [M+1, K] least-squares encode
    return B, A


# ---------------------------------------------------------------------------
# Aperiodicity band geometry.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ap_band_edges(sample_rate: int, num_bands: int) -> np.ndarray:
    """Band edges in Hz, linearly spaced over [0, fs/2]."""
    return np.linspace(0.0, sample_rate / 2.0, num_bands + 1)


@functools.lru_cache(maxsize=None)
def ap_band_masks(sample_rate: int, num_bands: int, fft_size: int):
    """Binary masks [B, fft_size//2+1] selecting each band's rfft bins."""
    edges = ap_band_edges(sample_rate, num_bands)
    freqs = np.arange(fft_size // 2 + 1) * sample_rate / fft_size
    masks = np.zeros((num_bands, fft_size // 2 + 1), dtype=np.float64)
    for b in range(num_bands):
        lo, hi = edges[b], edges[b + 1]
        sel = (freqs >= lo) & (freqs < hi) if b < num_bands - 1 else (
            (freqs >= lo) & (freqs <= hi))
        masks[b, sel] = 1.0
    return masks


@functools.lru_cache(maxsize=None)
def ap_band_centers(sample_rate: int, num_bands: int) -> np.ndarray:
    e = ap_band_edges(sample_rate, num_bands)
    return (e[:-1] + e[1:]) / 2.0


@functools.lru_cache(maxsize=None)
def ap_expand_matrix(sample_rate: int, num_bands: int, spec_bins: int):
    """[K, B] matrix: piecewise-linear interp of band values to spec bins."""
    centers = ap_band_centers(sample_rate, num_bands)
    freqs = np.arange(spec_bins) * (sample_rate / 2.0) / (spec_bins - 1)
    W = np.zeros((spec_bins, num_bands), dtype=np.float64)
    for k, f in enumerate(freqs):
        if f <= centers[0]:
            W[k, 0] = 1.0
        elif f >= centers[-1]:
            W[k, -1] = 1.0
        else:
            j = int(np.searchsorted(centers, f) - 1)
            t = (f - centers[j]) / (centers[j + 1] - centers[j])
            W[k, j] = 1.0 - t
            W[k, j + 1] = t
    return W


# ---------------------------------------------------------------------------
# Synthesis scale conventions (harmonic + noise, SURVEY.md §3.4 reborn).
#
# The analysis envelope is |STFT|^2 with a periodic Hann window of length
# fft_size.  A sinusoid of amplitude A at a bin-centered frequency measures
# E = (A * sum(w) / 2)^2 at its peak, so resynthesis of a harmonic with
# target amplitude A uses A = 2*sqrt(E)/sum(w).  White noise of variance s^2
# measures E = s^2 * sum(w^2); the noise branch inverts that.
# ---------------------------------------------------------------------------

def analysis_window_sum(fft_size: int) -> float:
    return float(np.sum(hann(fft_size)))           # = fft_size/2 exactly


def analysis_window_sumsq(fft_size: int) -> float:
    return float(np.sum(hann(fft_size) ** 2))      # = 3*fft_size/8 exactly


def noise_fft_size(hop: int) -> int:
    """Noise OLA frame length: 4*hop gives exact COLA for Hann windows."""
    return 4 * hop


@functools.lru_cache(maxsize=None)
def noise_window(hop: int) -> np.ndarray:
    return hann(noise_fft_size(hop))


@functools.lru_cache(maxsize=None)
def noise_ola_norm(hop: int) -> np.ndarray:
    """Per-sample OLA power normalizer, periodic with period `hop`.

    Independent noise segments add in POWER; the steady-state summed squared
    window at phase p is  sum_m w[p + m*hop]^2 .  OLA output is divided by
    the sqrt of this (applied periodically everywhere, including edges, so
    streamed and offline synthesis share one convention).
    """
    w = noise_window(hop)
    n = noise_fft_size(hop)
    acc = np.zeros(hop)
    for m in range(n // hop):
        acc += w[m * hop: (m + 1) * hop] ** 2
    return np.sqrt(acc)


@functools.lru_cache(maxsize=None)
def noise_spec_interp_matrix(fft_size: int, hop: int):
    """[K_noise, K] linear-interp matrix resampling the envelope's rfft grid
    (fft_size) onto the noise synthesis rfft grid (4*hop)."""
    k_env = fft_size // 2 + 1
    n_noise = noise_fft_size(hop)
    k_noise = n_noise // 2 + 1
    pos = np.arange(k_noise) * (k_env - 1) / (k_noise - 1)
    W = np.zeros((k_noise, k_env), dtype=np.float64)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, k_env - 1)
    t = pos - lo
    for i in range(k_noise):
        W[i, lo[i]] += 1.0 - t[i]
        W[i, hi[i]] += t[i]
    return W


@functools.lru_cache(maxsize=None)
def noise_band_interp_matrix(fft_size: int, hop: int, sample_rate: int,
                             num_bands: int):
    """[K_noise, B]: band aperiodicity straight onto the noise rfft grid.

    Exactly ``noise_spec_interp_matrix @ ap_expand_matrix`` folded in
    float64 — the device never materializes the [.., K] expanded
    aperiodicity for the noise branch."""
    return noise_spec_interp_matrix(fft_size, hop) @ ap_expand_matrix(
        sample_rate, num_bands, fft_size // 2 + 1)


def derived_geometry(cfg: DspConfig) -> dict:
    """Convenience bag of static sizes used across golden and JAX paths."""
    return dict(
        hop=cfg.hop,
        fft_size=cfg.fft_size,
        spec_bins=cfg.spec_bins,
        lag_min=cfg.lag_min,
        lag_max=cfg.lag_max,
        num_lags=cfg.num_lags,
        f0_window=cfg.f0_window,
        f0_frame_len=cfg.f0_frame_len,
        noise_fft=noise_fft_size(cfg.hop),
    )
