"""The HiFi-GAN V1 generator in plain PyTorch, float32: the reference the
program's ``"hifigan"`` vocoder mode is held to.

Kong, Kim & Bae, "HiFi-GAN" (NeurIPS 2020, arXiv:2010.05646), the generator
of ``config_v1.json`` (github.com/jik876/hifi-gan), written from its layer
list with ``torch.nn.functional`` alone::

    x = conv_pre(c)                           # D_in -> 512, k 7, pad 3
    for i, (u, k_u) in enumerate(zip(rates, up_kernels)):
        x = ConvTranspose1d(C_i -> C_i / 2, k_u, stride u,
                            pad (k_u - u) // 2)(leaky_relu(x, 0.1))
        x = mean over k in resblock_kernel_sizes of ResBlock1(k, ds)(x)
    y = tanh(Conv1d(C_n -> 1, k 7, pad 3)(leaky_relu(x, 0.01)))

    ResBlock1(k, ds)(x): for d in ds:
        t = Conv1d(C, C, k, dilation d, pad d (k - 1) / 2)(leaky_relu(x, 0.1))
        x = x + Conv1d(C, C, k, pad (k - 1) / 2)(leaky_relu(t, 0.1))

Every conv has a bias; weight norm is folded (inference weights).
Departures from the published generator: the rates multiply to this
system's hop of 120 (5·4·3·2, kernels 2u as in V1) where V1's make 256, so a
transposed conv of odd stride gives u·L + 1 samples and the last one is
cropped; ``conv_pre`` reads the 67 channels of the vocoders' conditioning
(mel-cepstrum, band aperiodicity, log F0, voicing) where the paper reads
80 mel bands.  At ``compute_dtype`` float8 every conv's input and kernel
are rounded through :func:`~benchmark.reference.models.acoustic.cast` (the
control)."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from benchmark.reference.models.acoustic import cast


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) \
        else v


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """The generator's layer list (the configuration's ``vocoder_hifigan``
    section), with V1's residual block, ResBlock1, the only one."""

    upsample_initial_channel: int = 512
    upsample_rates: tuple = (5, 4, 3, 2)
    upsample_kernel_sizes: tuple = (10, 8, 6, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    def __post_init__(self):
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, _tuples(getattr(self, f.name)))

    @property
    def hop(self) -> int:
        return math.prod(self.upsample_rates)

    @property
    def halo_frames(self) -> int:
        """Frames on either side that one input frame reaches: input frame
        0 pushed forward through every layer, the output samples it moves
        read as frames."""
        lo, hi = -3, 3                                      # conv_pre
        for u, k in zip(self.upsample_rates, self.upsample_kernel_sizes):
            p = (k - u) // 2
            lo, hi = lo * u - p, hi * u - p + k - 1         # transposed
            r = max(sum((d + 1) * (kr - 1) // 2 for d in ds)
                    for kr, ds in zip(self.resblock_kernel_sizes,
                                      self.resblock_dilation_sizes))
            lo, hi = lo - r, hi + r                         # resblocks
        lo, hi = lo - 3, hi + 3                             # conv_post
        return max(-(lo // self.hop), hi // self.hop)


class ResBlock1(nn.Module):
    def __init__(self, ch: int, k: int, dilations: tuple):
        super().__init__()
        self.dilations = dilations
        self.convs1 = nn.ModuleList(nn.Conv1d(ch, ch, k) for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(ch, ch, k) for _ in dilations)


def _conv(x, layer: nn.Conv1d, dtype, dilation: int = 1):
    k = layer.weight.shape[-1]
    pad = dilation * (k - 1) // 2
    y = Fn.conv1d(cast(Fn.pad(x, (pad, pad)), dtype),
                  cast(layer.weight, dtype), dilation=dilation)
    return y.float() + cast(layer.bias, dtype).float()[:, None]


def _up(x, layer: nn.ConvTranspose1d, u: int, dtype):
    k = layer.weight.shape[-1]
    L = x.shape[-1]
    y = Fn.conv_transpose1d(cast(x, dtype), cast(layer.weight, dtype),
                            stride=u, padding=(k - u) // 2)
    return y.float()[..., : L * u] + cast(layer.bias, dtype).float()[:, None]


class Generator(nn.Module):
    """[B, T, D_in] frame-major conditioning -> [B, T * hop] waveform,
    float32 (tensor names as the program's module names them)."""

    def __init__(self, cfg: HiFiGANConfig, d_in: int):
        super().__init__()
        self.cfg = cfg
        C = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(d_in, C, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            c_in, c_out = C >> i, C >> (i + 1)
            self.ups.append(nn.ConvTranspose1d(c_in, c_out, k, u))
            for kr, ds in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(c_out, kr, ds))
        self.conv_post = nn.Conv1d(C >> len(cfg.upsample_rates), 1, 7)

    def forward(self, c: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        x = _conv(c.transpose(1, 2).float(), self.conv_pre, dtype)
        n = len(self.cfg.resblock_kernel_sizes)
        for i, u in enumerate(self.cfg.upsample_rates):
            x = _up(Fn.leaky_relu(x, 0.1), self.ups[i], u, dtype)
            outs = []
            for rb in self.resblocks[i * n: (i + 1) * n]:
                h = x
                for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2):
                    t = _conv(Fn.leaky_relu(h, 0.1), c1, dtype, d)
                    h = h + _conv(Fn.leaky_relu(t, 0.1), c2, dtype)
                outs.append(h)
            x = torch.stack(outs).sum(0) / n
        y = _conv(Fn.leaky_relu(x, 0.01), self.conv_post, dtype)
        return torch.tanh(y[:, 0])

    def layers(self) -> dict[str, nn.Module]:
        """Every layer by its module name, in the published order."""
        return {n: m for n, m in self.named_modules()
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))}
