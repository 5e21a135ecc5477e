"""Learned frame->waveform decoder, the "wave" vocoder mode (PyTorch port of
``models/vocoder_wave.py``).

A conv stack predicts complex short-time spectra that are iSTFT'd (two
matrix products, ``ops/dft.py``) and overlap-added onto the DSP renderer's
output.  The head combines hidden features with cos/sin of P integer
multiples of the frame-boundary fundamental phase and of Q learnable
fractional ratios (each fractional track carries its own wrapped phase,
:class:`~benchmark.reference.dsp.synthesis.WaveCarry`), so residual
partials can phase-lock to the excitation.  Zero-initialised heads: at init
the residual is exactly 0 and the decoder is the DSP renderer.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference.config import DspConfig, VocoderWaveConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.synthesis import (WaveCarry,
                                                      integrate_phase,
                                                      ola_hop_blocks,
                                                      render_core,
                                                      synthesis_controls)
from benchmark.reference.models.acoustic import conv1d_valid
from benchmark.reference.models.initializers import init_module
from benchmark.reference.models.vocoder_nn import (gelu,
                                                          vocoder_input_dim,
                                                          vocoder_inputs)
from benchmark.reference.ops import dft


def residual_bins(dsp_cfg: DspConfig) -> int:
    return prim.noise_fft_size(dsp_cfg.hop) // 2 + 1


class WaveDecoderNet(nn.Module):
    """Conditioning [(B,) T, D] (+ phase tracks) -> complex residual spectra.

    ``forward(x, bphase, adv, no_reset, adv_out, no_reset_out, frac_base,
    out_start, out_len)`` runs the conv stack over all T rows (SAME
    padding), then the heads on rows [out_start, out_start+out_len) only —
    the rows whose phase tracks ``bphase``/``adv``/``no_reset`` [..., out_len]
    the caller holds (a :class:`~benchmark.reference.dsp.synthesis.
    PhaseTrack`).  Integer combs m*phi use the wrapped boundary phase;
    fractional track j's phase is its own wrapped base ``frac_base``
    [..., Q] (zeroed once the excitation resets) plus ratio_j times the
    unwrapped advance.  Returns (re, im [..., out_len, K], frac_out
    [..., Q]).  ``comb_head``'s channels are ordered (re/im, P+Q, K), as
    flax reshapes them.
    """

    ZERO_INIT = ("base_head", "comb_head")

    def __init__(self, cfg: VocoderWaveConfig, dsp_cfg: DspConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.k_res = residual_bins(dsp_cfg)
        tracks = cfg.phase_harmonics + cfg.phase_fractional
        self.stem = nn.Conv1d(vocoder_input_dim(dsp_cfg), h, 1)
        self.convs = nn.ModuleList(nn.Conv1d(h, h, cfg.kernel_size)
                                   for _ in range(cfg.num_blocks))
        self.base_head = nn.Conv1d(h, 2 * self.k_res, 1)
        self.comb_head = nn.Conv1d(h, 2 * tracks * self.k_res, 1)
        self.frac_ratios = nn.Parameter(
            0.5 + torch.arange(cfg.phase_fractional, dtype=torch.float32))

    def flax_layers(self) -> dict[str, nn.Module]:
        """flax path -> layer, the names of ``flatten_params``."""
        layers = {"stem": self.stem, "base_head": self.base_head,
                  "comb_head": self.comb_head}
        for i, conv in enumerate(self.convs):
            layers[f"conv_{i}"] = conv
        return layers

    def flax_params(self) -> dict[str, torch.Tensor]:
        """flax path -> plain (non-layer) parameter."""
        return ({"frac_ratios": self.frac_ratios}
                if self.cfg.phase_fractional > 0 else {})

    def forward(self, x, bphase, adv, no_reset, adv_out, no_reset_out,
                frac_base, out_start: int, out_len: int,
                dtype=torch.float32):
        c = self.cfg
        P, Q, K = c.phase_harmonics, c.phase_fractional, self.k_res
        pad = c.kernel_size // 2                              # SAME, odd k
        h = conv1d_valid(x, self.stem, dtype)
        for conv in self.convs:
            h = h + conv1d_valid(gelu(h), conv, dtype, padding=pad)
        h = gelu(h)[..., out_start: out_start + out_len, :]
        # phases and spectra in the parameters' dtype: float32, or float64
        # for a float64 witness of the float32 gradient
        acc = self.frac_ratios.dtype
        m_int = torch.arange(1, P + 1, dtype=acc, device=x.device)
        ang = bphase[..., :, None].to(acc) * m_int
        frac_out = frac_base
        if Q > 0:
            keep = no_reset[..., :, None].to(acc)
            ang_frac = (keep * frac_base[..., None, :]
                        + adv[..., :, None].to(acc) * self.frac_ratios)
            ang = torch.cat([ang, ang_frac], dim=-1)
            keep_out = no_reset_out[..., None].to(acc)
            frac_out = torch.remainder(
                keep_out * frac_base + adv_out[..., None].to(acc)
                * self.frac_ratios, 2.0 * math.pi)
        cosm, sinm = torch.cos(ang), torch.sin(ang)   # [..., out_len, P+Q]
        # phase-free residual (noise, transients) ...
        b_re, b_im = torch.chunk(
            conv1d_valid(h, self.base_head, dtype).to(acc), 2, dim=-1)
        # ... plus phase-locked combs: spec += sum_m C_m e^{j mult_m phi}
        comb = conv1d_valid(h, self.comb_head, dtype).to(acc)
        comb = comb.reshape(*comb.shape[:-1], 2, P + Q, K)
        c_re, c_im = comb[..., 0, :, :], comb[..., 1, :, :]
        re = (b_re + torch.einsum("...pk,...p->...k", c_re, cosm)
              - torch.einsum("...pk,...p->...k", c_im, sinm))
        im = (b_im + torch.einsum("...pk,...p->...k", c_re, sinm)
              + torch.einsum("...pk,...p->...k", c_im, cosm))
        return re, im, frac_out


def waveform_vocode(net: WaveDecoderNet, f0, env, ap, mc, noise,
                    wd_cfg: VocoderWaveConfig, dsp_cfg: DspConfig,
                    carry: WaveCarry | None = None, out_ctx: int = 0,
                    dtype=torch.float32) -> tuple[torch.Tensor, WaveCarry]:
    """Full "wave" vocoder: DSP render + learned iSTFT residual.

    Feature args are frame-major with rows = F + 1 + 2*out_ctx (the F+1
    renderer rows plus ``out_ctx`` conv-context rows on each side; 0
    offline), optionally batched; noise [(B,) F, k, 2].  ``wd_cfg`` is the
    config ``net`` was built from.  Returns (wave [(B,) F*hop], next
    carry).
    """
    F = f0.shape[-1] - 1 - 2 * out_ctx
    hop = dsp_cfg.hop
    n_noise = prim.noise_fft_size(hop)
    if carry is None:
        carry = WaveCarry.zeros(dsp_cfg, f0.device, torch.float32,
                                wd_cfg.phase_fractional,
                                tuple(f0.shape[:-1]))

    sl = slice(out_ctx, out_ctx + F + 1)
    amps, nmag, f0f, voiced = synthesis_controls(
        f0[..., sl], env[..., sl, :], ap[..., sl, :], dsp_cfg)
    track = integrate_phase(f0f, voiced, dsp_cfg, carry.synth)
    base, synth_carry = render_core(amps, nmag, track, noise, dsp_cfg,
                                    carry.synth)

    x = vocoder_inputs(f0, mc, ap).to(dtype)
    re, im, frac_out = net(x, track.boundaries, track.adv, track.no_reset,
                           track.adv_out, track.no_reset_out,
                           carry.frac_phase, out_ctx, F, dtype)
    w = dft.device_const(prim.noise_window, hop, like=re)
    seg = dft.irfft_real(re, im, n_noise) * w
    # amplitude-exact COLA: 4x-overlapped periodic Hann sums to 2.0
    res, res_tail = ola_hop_blocks(seg, carry.res_tail, hop)
    return base + res / 2.0, WaveCarry(synth=synth_carry, res_tail=res_tail,
                                       frac_phase=frac_out)


def init_wave_params(wd_cfg: VocoderWaveConfig, dsp_cfg: DspConfig,
                     generator: torch.Generator) -> WaveDecoderNet:
    """A freshly initialised wave decoder (flax's initialisers; fractional
    ratios on the half-integers)."""
    return init_module(WaveDecoderNet(wd_cfg, dsp_cfg), generator)
