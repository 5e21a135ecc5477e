"""The BigVGAN v2 generator, the "bigvgan" vocoder mode (the port's alone;
the JAX package has no counterpart).

Lee et al., "BigVGAN: A Universal Neural Vocoder with Large-Scale
Training" (ICLR 2023, arXiv:2206.04658), the generator of
``configs/bigvgan_v2_24khz_100band_256x.json`` (github.com/NVIDIA/BigVGAN)
at inference: weight norm folded, as in the hifigan mode.  Over
conditioning rows ``c`` [B, D_in, T]::

    x = conv_pre(c)                                  # D_in -> C, k 7
    for each stage i (rate u, kernel k_u):
        x = ConvTranspose1d(C_i -> C_i / 2, k_u, stride u,
                            pad (k_u - u) // 2)(x)   # no activation before
        x = mean over the resblock kernels k of AMPBlock1(k)(x)
    y = clamp(conv_post(Act(x)), -1, 1)              # C_n -> 1, k 7, no bias

    AMPBlock1(k, ds)(x): for d in ds:
        x = x + conv_k(Act_b(conv_k,d(Act_a(x))))

with every other conv SAME-padded and biased, and every ``Act`` an
anti-aliased SnakeBeta with its own per-channel log-scale alpha and beta
(``ops/bigvgan_act.py``).  Each conditioning row is the mean of an aligned
pair of frames (``VocoderBigVGANConfig.frames_per_row``): the rates give
240 samples a row, two hops of 120.

It runs on the HiFi-GAN generator's skeleton
(``models/vocoder_hifigan.py:HiFiGANGenerator.forward``): channels-last
activations, every convolution on an NHWC view without bias, each layer
over its dependency cone (``VocoderBigVGANConfig.cone``, whose walk counts
each activation's reach of 5 rows and the pairing), and one pass between
two convolutions.  A pass with an activation is ``ops/bigvgan_act.py``'s
(the CUDA kernel ``csrc/bigvgan_act.cu`` on the card): a transposed conv's
bias and the first block's first activation; a first conv's bias and
activation; a second conv's bias, residual and the next activation; the
last stage's mean and activation_post; and, for the second and third
blocks of a stage, their own first activation of the stage's rows.  One
without is ``ops/hifigan_tail.py``'s at slope 1 (the identity): conv_pre's
bias, a block's last sum and a stage's mean.  18 passes a stage with an
activation and 3 without, activation_post and conv_pre's.  Kernels and
activations in the compute dtype (bfloat16 on the default path), biases,
alpha, 1 / beta and the passes' arithmetic in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from realtime_yukarin_tpu_torch.config import DspConfig, VocoderBigVGANConfig
from realtime_yukarin_tpu_torch.models.vocoder_hifigan import (
    HiFiGANGenerator, _conv)
from realtime_yukarin_tpu_torch.ops.bigvgan_act import bigvgan_act
from realtime_yukarin_tpu_torch.ops.hifigan_tail import hifigan_tail

SNAKE_EPS = 1e-9        # BigVGAN's no_div_by_zero
IDENTITY = 1.0          # hifigan_tail's slope where no activation follows


class SnakeBeta(nn.Module):
    """One activation's parameters: log alpha and log beta per channel
    (``snake_logscale``; zeros, alpha = beta = 1, at init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def packed(self, dtype: torch.dtype) -> tuple:
        """(alpha, 1 / (beta + 1e-9)) in ``dtype``, contiguous."""
        a = torch.exp(self.alpha.detach().to(dtype))
        b = torch.exp(self.beta.detach().to(dtype))
        return a.contiguous(), (1.0 / (b + SNAKE_EPS)).contiguous()


class AMPBlock1(nn.Module):
    """BigVGAN's residual block: per dilation d a dilated k-tap conv and a
    plain one, each after its own activation, added to the input
    (``activations`` in BigVGAN's order: a, b for each dilation).  Holds
    the weights; :class:`BigVGANGenerator` runs it channels-last."""

    def __init__(self, channels: int, kernel: int, dilations: tuple):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel)
                                    for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel)
                                    for _ in dilations)
        self.activations = nn.ModuleList(SnakeBeta(channels)
                                         for _ in range(2 * len(dilations)))


class Packed(NamedTuple):
    """The HiFi-GAN layout (``vocoder_hifigan.Packed``) and the
    activations: ``acts`` by stage, then block, each block's (alpha,
    inv_beta) in BigVGAN's order; ``post_act`` activation_post's."""
    pre: tuple
    ups: tuple
    blocks: tuple
    post: tuple
    acts: tuple
    post_act: tuple


class BigVGANGenerator(HiFiGANGenerator):
    """Frames [..., T, D_in] -> waveform [..., (T // 2) * 240] (float32),
    or with ``out_ctx`` the samples of frames [out_ctx, T - out_ctx - 1)
    alone, each layer run over the rows those samples depend on; the
    markers as :class:`HiFiGANGenerator`'s."""

    BLOCK = AMPBlock1
    POST_BIAS = False

    def __init__(self, cfg: VocoderBigVGANConfig, dsp_cfg: DspConfig):
        super().__init__(cfg, dsp_cfg)
        self.activation_post = SnakeBeta(
            cfg.channels(len(cfg.upsample_rates) - 1))

    def flax_params(self) -> dict[str, torch.Tensor]:
        """The activations' parameters by their ``.npz`` names."""
        out = {}
        for j, rb in enumerate(self.resblocks):
            for m, act in enumerate(rb.activations):
                out[f"resblocks_{j}/activations_{m}/alpha"] = act.alpha
                out[f"resblocks_{j}/activations_{m}/beta"] = act.beta
        out["activation_post/alpha"] = self.activation_post.alpha
        out["activation_post/beta"] = self.activation_post.beta
        return out

    def _pack(self, dtype, keep) -> Packed:
        base = super()._pack(dtype, keep)
        f = torch.promote_types(dtype, torch.float32)
        n = len(self.cfg.resblock_kernel_sizes)
        acts = tuple(tuple(tuple(keep(*a.packed(f)) for a in rb.activations)
                           for rb in self.resblocks[i * n: (i + 1) * n])
                     for i in range(len(self.ups)))
        return Packed(*base, acts, keep(*self.activation_post.packed(f)))

    def _pre_tail(self, y, w: Packed, start: int, length: int):
        return hifigan_tail("act", y, w.pre[1], slope=IDENTITY,
                            length=length, start=start)[0]

    def _up_tail(self, y, w: Packed, i: int, start: int, length: int):
        # the crop: an odd rate's trailing sample is no row of the stage
        extent = y.shape[1] - y.shape[1] % self.cfg.upsample_rates[i]
        return bigvgan_act(y, w.acts[i][0][0], w.ups[i][1], keep_v=True,
                           start=start, length=length, extent=extent)

    def _stage(self, h, a, w: Packed, i: int, keep: tuple, last: bool):
        n = len(self.cfg.resblock_kernel_sizes)
        acc = None
        for j, (layers, acts, ds) in enumerate(zip(
                w.blocks[i], w.acts[i], self.cfg.resblock_dilation_sizes)):
            x = h
            xa = a if j == 0 else bigvgan_act(h, acts[0])[0]
            for m, (d, (w1, b1, w2, b2)) in enumerate(zip(ds, layers)):
                (t,) = bigvgan_act(_conv(xa, w1, d), acts[2 * m + 1], b1)
                v = _conv(t, w2)
                if m < len(ds) - 1:
                    x, xa = bigvgan_act(v, acts[2 * m + 2], b2, r=x,
                                        keep_v=True)
                elif j < n - 1:
                    (acc,) = hifigan_tail("sum", v, b2, r=x, acc=acc)
                elif last:
                    return bigvgan_act(v, w.post_act, b2, r=x, acc=acc,
                                       divisor=float(n), start=keep[0],
                                       length=keep[1])[0]
                else:
                    return hifigan_tail("mean", v, b2, r=x, acc=acc,
                                        slope=IDENTITY, divisor=float(n),
                                        length=keep[1], start=keep[0])[0]

    def _post_tail(self, y, w: Packed) -> torch.Tensor:
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        return torch.clamp(y, -1.0, 1.0)
