"""The HiFi-GAN V1 generator, the "hifigan" vocoder mode (the port's alone;
the JAX package has no counterpart).

Kong, Kim & Bae, "HiFi-GAN" (NeurIPS 2020, arXiv:2010.05646), generator of
``config_v1.json`` (github.com/jik876/hifi-gan), at inference: weight norm
is a reparameterisation for training only, so the weights here are the
folded, plain ones.  Over frames ``c`` [B, D_in, T]::

    x = conv_pre(c)                                  # D_in -> C, k 7
    for each stage i (rate u, kernel k_u):
        x = ConvTranspose1d(C_i -> C_i / 2, k_u, stride u,
                            pad (k_u - u) // 2)(leaky_relu(x, 0.1))
        x = mean over the resblock kernels k of ResBlock1(k)(x)
    y = tanh(conv_post(leaky_relu(x, 0.01)))         # C_n -> 1, k 7

    ResBlock1(k, ds)(x): for d in ds:
        x = x + conv_k(leaky_relu(conv_k,d(leaky_relu(x, 0.1)), 0.1))

with every conv SAME-padded and biased.  A transposed conv of odd stride u
and kernel 2u gives u·L + 1 samples; the trailing one is cropped, so every
stage gives u samples a frame and frame t owns output samples
[t·hop, (t + 1)·hop).  Channels-first inside, frame-major [..., T, D_in]
at the boundary like the other vocoders; kernels and activations in the
compute dtype (bfloat16 on the default path), the output in float32 (or
float64, for a float64 witness).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from realtime_yukarin_tpu_torch.config import DspConfig, VocoderHiFiGANConfig
from realtime_yukarin_tpu_torch.models.vocoder_nn import (vocoder_input_dim,
                                                          vocoder_inputs)

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01       # the generator's last activation: torch's default


def _conv(x, conv: nn.Conv1d, dtype, dilation: int = 1) -> torch.Tensor:
    """SAME-padded ``conv`` on [B, C, T] in ``dtype`` (odd kernel)."""
    k = conv.kernel_size[0]
    return Fn.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                     padding=dilation * (k - 1) // 2, dilation=dilation)


class ResBlock1(nn.Module):
    """V1's residual block: per dilation d a dilated k-tap conv and a plain
    one, each after a leaky ReLU, added to the input."""

    def __init__(self, channels: int, kernel: int, dilations: tuple):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel)
                                    for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel)
                                    for _ in dilations)

    def forward(self, x, dtype):
        for d, c1, c2 in zip(self.dilations, self.convs1, self.convs2):
            t = _conv(Fn.leaky_relu(x, LRELU_SLOPE), c1, dtype, d)
            x = x + _conv(Fn.leaky_relu(t, LRELU_SLOPE), c2, dtype)
        return x


class HiFiGANGenerator(nn.Module):
    """Conditioning [..., T, D_in] -> waveform [..., T * hop] (float32).

    ``forward(x, dtype, mark)`` calls ``mark("vocoder_s<i>")`` before
    upsampling stage i (1-based) and ``mark("vocoder")`` before conv_post:
    the stage markers of ``utils/profiling.py``."""

    ZERO_INIT = ()

    def __init__(self, cfg: VocoderHiFiGANConfig, dsp_cfg: DspConfig):
        super().__init__()
        if cfg.samples_per_frame != dsp_cfg.hop:
            raise ValueError(
                f"the upsample rates {cfg.upsample_rates} give "
                f"{cfg.samples_per_frame} samples a frame, the hop is "
                f"{dsp_cfg.hop}")
        self.cfg = cfg
        C = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(vocoder_input_dim(dsp_cfg), C, 7)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(C // 2 ** i, cfg.channels(i), k, u)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                           cfg.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            ResBlock1(cfg.channels(i), k, ds)
            for i in range(len(cfg.upsample_rates))
            for k, ds in zip(cfg.resblock_kernel_sizes,
                             cfg.resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(cfg.channels(len(cfg.upsample_rates) - 1),
                                   1, 7)

    def flax_layers(self) -> dict[str, nn.Module]:
        """name -> layer, in the published module order (the names of the
        ``.npz`` layout, ``models/voice_changer.py:flax_tensors``)."""
        layers = {"conv_pre": self.conv_pre}
        for i, up in enumerate(self.ups):
            layers[f"ups_{i}"] = up
        for j, rb in enumerate(self.resblocks):
            for m, (c1, c2) in enumerate(zip(rb.convs1, rb.convs2)):
                layers[f"resblocks_{j}/convs1_{m}"] = c1
                layers[f"resblocks_{j}/convs2_{m}"] = c2
        layers["conv_post"] = self.conv_post
        return layers

    def forward(self, x: torch.Tensor, dtype=torch.float32,
                mark: Callable[[str], None] | None = None) -> torch.Tensor:
        lead, (T, _) = x.shape[:-2], x.shape[-2:]
        mark = mark or (lambda stage: None)
        h = _conv(x.reshape(-1, T, x.shape[-1]).transpose(1, 2).to(dtype),
                  self.conv_pre, dtype)
        n = len(self.cfg.resblock_kernel_sizes)
        for i, (up, u) in enumerate(zip(self.ups, self.cfg.upsample_rates)):
            mark(f"vocoder_s{i + 1}")
            h = Fn.conv_transpose1d(
                Fn.leaky_relu(h, LRELU_SLOPE), up.weight.to(dtype),
                up.bias.to(dtype), stride=u,
                padding=(up.kernel_size[0] - u) // 2)[..., : T * u]
            T *= u
            acc = self.resblocks[i * n](h, dtype)
            for rb in self.resblocks[i * n + 1: (i + 1) * n]:
                acc = acc + rb(h, dtype)
            h = acc / n
        mark("vocoder")
        y = _conv(Fn.leaky_relu(h, POST_SLOPE), self.conv_post, dtype)
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        return torch.tanh(y).reshape(*lead, T)


def hifigan_vocode(net: HiFiGANGenerator, f0, mc, ap, dtype=torch.float32,
                   out_ctx: int = 0,
                   mark: Callable[[str], None] | None = None
                   ) -> torch.Tensor:
    """The generator over frame-major features ([..., T] f0, [..., T, M+1]
    mc, [..., T, B] ap, ``vocoder_inputs``' conditioning), keeping the
    samples of frames [out_ctx, T - out_ctx - 1): rows are F + 1 +
    2·out_ctx (the renderer's F + 1 plus the halo on each side; 0
    offline).  Returns [..., F * hop]."""
    F = f0.shape[-1] - 1 - 2 * out_ctx
    hop = net.cfg.samples_per_frame
    y = net(vocoder_inputs(f0, mc, ap), dtype, mark)
    return y[..., out_ctx * hop: (out_ctx + F) * hop]

