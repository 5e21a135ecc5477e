"""Neural vocoder, DDSP mode (PyTorch port of ``models/vocoder_nn.py``).

A 1-D conv control network predicts per-frame multiplicative corrections to
the DSP-derived harmonic amplitudes and noise magnitudes, and the shared
differentiable renderer (:func:`dsp.synthesis.render`) generates the
waveform.  The heads are zero-initialised, so the untrained vocoder
reproduces the DSP vocoder exactly.  Layouts follow the JAX package:
``[(B,) T, C]`` frame-major features; flax's ``nn.gelu`` is the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from benchmark.reference.config import DspConfig, VocoderNNConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.synthesis import (SynthCarry, render,
                                                      synthesis_controls)
from benchmark.reference.models.acoustic import conv1d_valid
from benchmark.reference.models.initializers import init_module


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: ``jax.nn.gelu(approximate=True)``, the tanh form."""
    return Fn.gelu(x, approximate="tanh")


def vocoder_input_dim(dsp_cfg: DspConfig) -> int:
    """mc, band aperiodicity, log-f0 and the voiced flag."""
    return dsp_cfg.mc_dim + dsp_cfg.num_ap_bands + 2


class VocoderControlNet(nn.Module):
    """[(B,) T, D_in] -> (log harmonic scale [(B,) T, H], log noise scale
    [(B,) T, Kn]), float32."""

    ZERO_INIT = ("harm_head", "noise_head")

    def __init__(self, cfg: VocoderNNConfig, dsp_cfg: DspConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        k_noise = prim.noise_fft_size(dsp_cfg.hop) // 2 + 1
        self.stem = nn.Conv1d(vocoder_input_dim(dsp_cfg), h, 1)
        self.convs = nn.ModuleList(nn.Conv1d(h, h, cfg.kernel_size)
                                   for _ in range(cfg.num_blocks))
        self.harm_head = nn.Conv1d(h, dsp_cfg.num_harmonics, 1)
        self.noise_head = nn.Conv1d(h, k_noise, 1)

    def flax_layers(self) -> dict[str, nn.Module]:
        """flax path -> layer, the names of ``flatten_params``."""
        layers = {"stem": self.stem, "harm_head": self.harm_head,
                  "noise_head": self.noise_head}
        for i, conv in enumerate(self.convs):
            layers[f"conv_{i}"] = conv
        return layers

    def forward(self, x: torch.Tensor, dtype=torch.float32):
        pad = self.cfg.kernel_size // 2                       # SAME, odd k
        h = conv1d_valid(x, self.stem, dtype)
        for conv in self.convs:
            h = h + conv1d_valid(gelu(h), conv, dtype, padding=pad)
        h = gelu(h)
        return (conv1d_valid(h, self.harm_head, dtype).float(),
                conv1d_valid(h, self.noise_head, dtype).float())


def vocoder_inputs(f0: torch.Tensor, mc: torch.Tensor, ap: torch.Tensor
                   ) -> torch.Tensor:
    """Control-net input [..., T, D_in]: mc, ap, log-f0 on voiced frames,
    voiced flag."""
    voiced = (f0 > 0).to(mc.dtype)
    logf0 = torch.where(f0 > 0, torch.log(torch.clamp(f0, min=1.0)),
                        torch.zeros_like(f0))
    return torch.cat([mc, ap, logf0[..., None], voiced[..., None]], dim=-1)


def neural_vocoder_controls(net: VocoderControlNet, f0: torch.Tensor,
                            env: torch.Tensor, ap: torch.Tensor,
                            mc: torch.Tensor, voc_cfg: VocoderNNConfig,
                            dsp_cfg: DspConfig, dtype=torch.float32):
    """DSP controls modulated by the control net.  All args frame-major
    with F+1 frames (the renderer's lookahead convention), optionally
    batched: mc [(B,) F+1, M+1].  ``voc_cfg`` is the config ``net`` was
    built from.  Returns (amps', noise_mag', f0_filled, voiced) ready for
    ``render``."""
    amps, noise_mag, f0f, voiced = synthesis_controls(f0, env, ap, dsp_cfg)
    log_h, log_n = net(vocoder_inputs(f0, mc, ap), dtype)
    # multiplicative corrections, == 1 at init (zero-init heads)
    amps = amps * torch.exp(torch.clamp(log_h, -6.0, 6.0))
    noise_mag = noise_mag * torch.exp(torch.clamp(log_n[..., :-1, :],
                                                  -6.0, 6.0))
    return amps, noise_mag, f0f, voiced


def neural_vocode(net: VocoderControlNet, f0, env, ap, mc, noise,
                  voc_cfg: VocoderNNConfig, dsp_cfg: DspConfig,
                  carry: SynthCarry | None = None, dtype=torch.float32):
    """Full neural vocoder: controls -> shared renderer -> waveform
    [(B,) F*hop] and the next carry."""
    amps, noise_mag, f0f, voiced = neural_vocoder_controls(
        net, f0, env, ap, mc, voc_cfg, dsp_cfg, dtype)
    return render(amps, noise_mag, f0f, voiced, noise, dsp_cfg, carry)


def init_vocoder_params(voc_cfg: VocoderNNConfig, dsp_cfg: DspConfig,
                        generator: torch.Generator) -> VocoderControlNet:
    """A freshly initialised control net (flax's initialisers)."""
    return init_module(VocoderControlNet(voc_cfg, dsp_cfg), generator)
