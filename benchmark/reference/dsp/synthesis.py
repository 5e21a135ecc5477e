"""Waveform synthesis — harmonic + noise with explicit carry (PyTorch port
of ``dsp/synthesis.py``).

A coherent harmonic bank (fundamental phase integrated per sample; harmonic
h's phase is h times the fundamental) plus gaussian noise shaped per frame
in the rfft domain and overlap-added with an exact-COLA window.  The
renderer's state across chunks (phase, voicing, OLA tail) is the explicit
:class:`SynthCarry`.  The harmonic branch is the differentiable bank of
``ops/harmonic_bank.py`` (CUDA kernels on the card).

Every function takes optional leading batch dimensions (``[..., F+1, H]``
amplitudes, ``[..., F, hop]`` phase): training renders a batch of
utterances where the JAX package ``vmap``s, and a render of B utterances
hands the bank all B*F frame rows in one launch.  The renderer is out of
place, so autograd differentiates it back into the controls.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from benchmark.reference.config import DspConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.framing import lerp_rows
from benchmark.reference.ops import dft
from benchmark.reference.ops.harmonic_bank import harmonic_bank


@dataclasses.dataclass
class SynthCarry:
    """Synthesis state carried across chunks.

    The fundamental phase resets to 0 at every unvoiced->voiced onset, so
    the phase track (and streamed output) is a pure function of the F0
    contour.  ``voiced_prev`` is the voicing of the frame preceding the
    next chunk.
    """
    phase: torch.Tensor        # [...] fundamental phase (radians, wrapped)
    voiced_prev: torch.Tensor  # [...] bool
    noise_tail: torch.Tensor   # [..., noise_fft - hop] OLA tail

    @classmethod
    def zeros(cls, cfg: DspConfig, device, dtype=torch.float32,
              batch: tuple = ()) -> "SynthCarry":
        n_noise = prim.noise_fft_size(cfg.hop)
        return cls(phase=torch.zeros(batch, dtype=dtype, device=device),
                   voiced_prev=torch.zeros(batch, dtype=torch.bool,
                                           device=device),
                   noise_tail=torch.zeros((*batch, n_noise - cfg.hop),
                                          dtype=dtype, device=device))


@dataclasses.dataclass
class WaveCarry:
    """Carry of the "wave" vocoder mode: the DSP renderer's state plus the
    learned residual's own OLA tail and each fractional phase track's own
    wrapped phase (``models/vocoder_wave.py``).  A track with a non-integer
    ratio r cannot be derived from the wrapped fundamental (cos(r * (phi
    mod 2pi)) jumps at every wrap), so each accumulates r times the
    unwrapped advance and wraps itself."""
    synth: SynthCarry
    res_tail: torch.Tensor     # [..., noise_fft - hop]
    frac_phase: torch.Tensor   # [..., Q] per-fractional-track wrapped phase

    @classmethod
    def zeros(cls, cfg: DspConfig, device, dtype=torch.float32,
              phase_fractional: int = 0, batch: tuple = ()) -> "WaveCarry":
        n = prim.noise_fft_size(cfg.hop)
        return cls(synth=SynthCarry.zeros(cfg, device, dtype, batch),
                   res_tail=torch.zeros((*batch, n - cfg.hop), dtype=dtype,
                                        device=device),
                   frac_phase=torch.zeros((*batch, phase_fractional),
                                          dtype=dtype, device=device))


def harmonic_amplitudes(f0: torch.Tensor, env: torch.Tensor,
                        ap: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """Per-frame harmonic amplitudes [..., F', H] from controls [..., F',
    ...].

    env [..., F', K] on the rfft bin grid; ap [..., F', B] band values,
    interpolated at each harmonic directly."""
    fs = float(cfg.sample_rate)
    N = cfg.fft_size
    K = cfg.spec_bins
    B = cfg.num_ap_bands
    lead = f0.shape
    f0 = f0.reshape(-1)
    env = env.reshape(-1, env.shape[-1])
    ap = ap.reshape(-1, ap.shape[-1])
    wsumsq = prim.analysis_window_sumsq(N)
    h_idx = torch.arange(1, cfg.num_harmonics + 1, dtype=env.dtype,
                         device=env.device)

    voiced = (f0 > 0).to(env.dtype)
    f0f = torch.where(f0 > 0, f0, torch.full_like(f0, prim.DEFAULT_F0))
    freqs = h_idx[None, :] * f0f[:, None]                     # [F', H]
    pos = torch.clamp(freqs * N / fs, 0.0, K - 1.0)
    e_h = lerp_rows(env, pos)
    if B > 1:
        centers = prim.ap_band_centers(cfg.sample_rate, B)
        pos_b = torch.clamp((pos * (fs / N) - float(centers[0]))
                            / float(centers[1] - centers[0]), 0.0, B - 1.0)
        ap_h = lerp_rows(ap, pos_b)
    else:
        ap_h = ap[:, :1].expand(freqs.shape)
    alias_ok = (freqs < prim.HARMONIC_NYQUIST_FRACTION * fs / 2.0
                ).to(env.dtype)
    amps = (torch.sqrt(4.0 * torch.clamp(e_h, min=0.0)
                       * f0f[:, None] / (fs * wsumsq))
            * torch.sqrt(torch.clamp(1.0 - ap_h ** 2, 0.0, 1.0))
            * voiced[:, None] * alias_ok)
    return amps.reshape(*lead, amps.shape[-1])


def synthesis_controls(f0: torch.Tensor, env: torch.Tensor, ap: torch.Tensor,
                       cfg: DspConfig):
    """(amps [..., F+1, H], noise_mag [..., F, k_noise], f0_filled
    [..., F+1], voiced [..., F+1]) — the inputs of :func:`render`."""
    F = f0.shape[-1] - 1
    hop = cfg.hop
    N = cfg.fft_size
    n_noise = prim.noise_fft_size(hop)

    amps = harmonic_amplitudes(f0, env, ap, cfg)              # [F+1, H]
    f0f = torch.where(f0 > 0, f0, torch.full_like(f0, prim.DEFAULT_F0))

    wsumsq = prim.analysis_window_sumsq(N)
    Wn = dft.device_const(prim.noise_spec_interp_matrix, N, hop, like=env)
    Wna = dft.device_const(prim.noise_band_interp_matrix, N, hop,
                           cfg.sample_rate, cfg.num_ap_bands, like=env)
    e_noise = env[..., :F, :] @ Wn.T                          # [F, k_noise]
    ap_noise = ap[..., :F, :] @ Wna.T
    noise_mag = torch.sqrt(torch.clamp(e_noise * ap_noise ** 2, min=0.0)
                           * n_noise / wsumsq)
    return amps, noise_mag, f0f, f0 > 0


def synthesize(f0: torch.Tensor, env: torch.Tensor, ap: torch.Tensor,
               noise: torch.Tensor, cfg: DspConfig,
               carry: SynthCarry | None = None
               ) -> tuple[torch.Tensor, SynthCarry]:
    """F+1 frames of controls -> F*hop samples + next carry.

    f0 [F+1], env [F+1, K], ap [F+1, B], noise [F, noise_bins, 2] (each
    with optional leading batch dims).  Controls for sample n in
    [i*hop, (i+1)*hop) interpolate frames i, i+1.
    """
    amps, noise_mag, f0f, voiced = synthesis_controls(f0, env, ap, cfg)
    return render(amps, noise_mag, f0f, voiced, noise, cfg, carry)


@dataclasses.dataclass
class PhaseTrack:
    """Integrated excitation phase for F output frames (``adv`` and
    ``no_reset`` feed the wave vocoder's fractional tracks)."""
    phi: torch.Tensor         # [..., F, hop] per-sample fundamental phase
    boundaries: torch.Tensor  # [..., F] phase at each frame start (mod 2pi)
    frac: torch.Tensor        # [hop] intra-hop interpolation weight (0, 1]
    phase_out: torch.Tensor   # [...] carry-out phase
    vprev_out: torch.Tensor   # [...] carry-out voicing
    adv: torch.Tensor         # [..., F] unwrapped advance at each frame start
    no_reset: torch.Tensor    # [..., F] bool: no voicing reset up to frame i
    adv_out: torch.Tensor     # [...] advance at the carry-out point
    no_reset_out: torch.Tensor  # [...] bool: chunk had no voicing reset


def integrate_phase(f0f: torch.Tensor, voiced: torch.Tensor, cfg: DspConfig,
                    carry: SynthCarry) -> PhaseTrack:
    """Per-sample phase from the F0 contour.

    f0f [..., F+1] filled instantaneous F0 (Hz, never 0); voiced [..., F+1]
    bool.  Frame-boundary phases follow boundary_i = phase_{i-1} if (v_i &
    v_{i-1}) else 0, evaluated as a prefix sum with segment resets (the
    last reset at or before i is a running max of reset indices).

    The prefix sum over frames runs in float64: over a whole utterance
    (the offline render) it reaches thousands of radians, where a float32
    sum rounds each boundary by ~1e-4 rad and harmonic h multiplies that by
    h.  A streaming chunk's sum stays small either way."""
    F = f0f.shape[-1] - 1
    hop = cfg.hop
    fs = float(cfg.sample_rate)
    dtype, dev = f0f.dtype, f0f.device
    frac = (torch.arange(hop, dtype=dtype, device=dev) + 1.0) / hop
    f_inst = (f0f[..., :-1, None] * (1.0 - frac)
              + f0f[..., 1:, None] * frac)                    # [..., F, hop]
    cum = torch.cumsum(2.0 * math.pi * f_inst / fs, dim=-1)   # [..., F, hop]

    v = voiced[..., :-1]
    vprev = torch.cat([carry.voiced_prev[..., None], v[..., :-1]], dim=-1)
    cont = v & vprev
    idx = torch.arange(F, device=dev)
    reset_at = torch.where(cont, torch.full_like(idx, -1), idx)
    r = torch.cummax(reset_at, dim=-1).values                 # [..., F]
    f64 = torch.float64
    csum = torch.cat([torch.zeros((*cum.shape[:-2], 1), dtype=f64,
                                  device=dev),
                      torch.cumsum(cum[..., -1].to(f64), dim=-1)],
                     dim=-1)                                  # [.., F+1]
    base = torch.where(r < 0, carry.phase.to(f64)[..., None],
                       torch.zeros((), dtype=f64, device=dev))
    csum_r = torch.gather(csum, -1, torch.clamp(r, min=0))
    adv = csum[..., :F] - csum_r                              # [..., F]
    two_pi = 2.0 * math.pi
    boundaries = torch.remainder(base + adv, two_pi).to(dtype)  # [..., F]
    adv_out = csum[..., F] - csum_r[..., F - 1]
    phase_out = torch.remainder(base[..., F - 1] + adv_out, two_pi)
    phi = boundaries[..., None] + cum                         # [..., F, hop]
    return PhaseTrack(phi=phi, boundaries=boundaries, frac=frac,
                      phase_out=phase_out.to(dtype),
                      vprev_out=v[..., F - 1], adv=adv.to(dtype),
                      no_reset=r < 0, adv_out=adv_out.to(dtype),
                      no_reset_out=r[..., F - 1] < 0)


def ola_hop_blocks(seg: torch.Tensor, tail: torch.Tensor, hop: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-COLA overlap-add via block shifting.

    seg [..., F, n] windowed segments (segment i starts at sample i*hop);
    tail [..., n - hop] carry-in.  Returns (out [..., F*hop], tail_out
    [..., n - hop]).  Block m of segment i lands on output frame i+m; each
    block is added as a zero-padded shift (out of place, so autograd
    differentiates through it)."""
    F, n = seg.shape[-2:]
    n_blocks = n // hop
    blocks = seg.reshape(*seg.shape[:-1], n_blocks, hop)      # [.., F, m, hop]
    acc = torch.zeros((*seg.shape[:-2], F + n_blocks - 1, hop),
                      dtype=seg.dtype, device=seg.device)
    for m in range(n_blocks):
        acc = acc + Fn.pad(blocks[..., m, :], (0, 0, m, n_blocks - 1 - m))
    acc = acc.reshape(*seg.shape[:-2], -1)                    # [.., T + tail]
    T = F * hop
    acc = acc + Fn.pad(tail, (0, T))
    return acc[..., :T], acc[..., T:]


def render(amps: torch.Tensor, noise_mag: torch.Tensor, f0f: torch.Tensor,
           voiced: torch.Tensor, noise: torch.Tensor, cfg: DspConfig,
           carry: SynthCarry | None = None
           ) -> tuple[torch.Tensor, SynthCarry]:
    """Render a waveform from synthesis controls: amps [..., F+1, H],
    noise_mag [..., F, k_noise], f0f [..., F+1], voiced [..., F+1] bool,
    noise [..., F, k_noise, 2] unit gaussians."""
    if carry is None:
        carry = SynthCarry.zeros(cfg, amps.device, amps.dtype,
                                 tuple(amps.shape[:-2]))
    track = integrate_phase(f0f, voiced, cfg, carry)
    return render_core(amps, noise_mag, track, noise, cfg, carry)


def _noise_edge_weights(k: int) -> np.ndarray:
    """[2, k] factors of the noise spectrum's real and imaginary parts: the
    DC and Nyquist bins are real with doubled weight (matches golden)."""
    w = np.ones((2, k))
    w[0, [0, -1]] = math.sqrt(2.0)
    w[1, [0, -1]] = 0.0
    return w


def render_core(amps: torch.Tensor, noise_mag: torch.Tensor,
                track: PhaseTrack, noise: torch.Tensor, cfg: DspConfig,
                carry: SynthCarry) -> tuple[torch.Tensor, SynthCarry]:
    """Renderer body given a precomputed :class:`PhaseTrack`."""
    F = track.phi.shape[-2]
    hop = cfg.hop
    H = amps.shape[-1]
    lead = track.phi.shape[:-2]
    n_noise = prim.noise_fft_size(hop)

    # harmonic branch: every frame row of every utterance in one bank call
    harm = harmonic_bank(amps[..., :-1, :].reshape(-1, H).contiguous(),
                         amps[..., 1:, :].reshape(-1, H).contiguous(),
                         track.phi.reshape(-1, hop).contiguous(), track.frac)
    harm = harm.reshape(*lead, F * hop)

    # noise branch
    root2 = math.sqrt(2.0)
    k = noise_mag.shape[-1]
    edge_re = dft.device_const(_noise_edge_weights, k, like=noise_mag,
                               index=0)
    edge_im = dft.device_const(_noise_edge_weights, k, like=noise_mag,
                               index=1)
    re = noise_mag * noise[..., 0] / root2 * edge_re
    im = noise_mag * noise[..., 1] / root2 * edge_im
    w_noise = dft.device_const(prim.noise_window, hop, like=noise_mag)
    seg = dft.irfft_real(re, im, n_noise) * w_noise

    acc, tail = ola_hop_blocks(seg, carry.noise_tail, hop)
    norm = dft.device_const(prim.noise_ola_norm, hop, like=acc).repeat(F)
    wave = harm + acc / norm
    return wave, SynthCarry(phase=track.phase_out,
                            voiced_prev=track.vprev_out, noise_tail=tail)
