"""The BigVGAN v2 generator in plain PyTorch, float32: the reference the
program's ``"bigvgan"`` vocoder mode is held to.

Lee et al., "BigVGAN: A Universal Neural Vocoder with Large-Scale
Training" (ICLR 2023, arXiv:2206.04658), the generator of
``configs/bigvgan_v2_24khz_100band_256x.json`` (github.com/NVIDIA/BigVGAN),
written from its layer list with ``torch.nn.functional`` alone::

    x = Conv1d(D_in -> 1536, k 7, pad 3)(c)                    # conv_pre
    for i, (u, k_u) in enumerate(zip(rates, up_kernels)):
        x = ConvTranspose1d(C_i -> C_i / 2, k_u, stride u,
                            pad (k_u - u) // 2)(x)     # no activation before
        x = (sum over k in (3, 7, 11) of AMPBlock1(k, (1, 3, 5))(x)) / 3
    x = Act(x)                                         # activation_post
    y = clamp(Conv1d(C_n -> 1, k 7, pad 3, bias=False)(x), -1, 1)

    AMPBlock1(k, ds)(x): for d in ds:     # its own two convs and two Acts
        t = Conv1d(C, C, k, dilation d, pad d (k - 1) / 2)(Act_a(x))
        x = x + Conv1d(C, C, k, pad (k - 1) / 2)(Act_b(t))

    Act(x) = Down2(SnakeBeta(Up2(x)))     # alpha, beta per channel and Act
    SnakeBeta(v) = v + sin(alpha v)^2 / (beta + 1e-9),
                   alpha = exp(a), beta = exp(b)                  # logscale
    Up2(x):   y = 2 * conv_transpose1d(replicate_pad(x, 5, 5), f,
                                       stride 2, per channel)[..., 15:-15]
    Down2(v): conv1d(replicate_pad(v, 5, 6), f, stride 2, per channel)
    f: 12-tap Kaiser-windowed sinc, cutoff 0.25, half-width 0.3, summing
       to 1 (:func:`kaiser_sinc`)

Every conv but conv_post has a bias; weight norm is folded (inference
weights).  Departures from the published generator: the rates are 5, 3,
2, 2, 2, 2 with kernels 10, 6, 4, 4, 4, 4 (BigVGAN's k_u = 2u), 240 samples
a conditioning row where the published 4, 4, 2, 2, 2, 2 make 256: no six
whole rates of at least 2 multiply to this system's hop of 120; each
conditioning row is the mean of an aligned pair of the system's frames
(``streaming/bigvgan.py``); ``conv_pre`` reads the 67 channels of the
vocoders' conditioning (mel-cepstrum, band aperiodicity, log F0, voicing)
where the paper reads 100 mel bands.  At ``compute_dtype`` float8 every
conv's input and kernel are rounded through
:func:`~benchmark.reference.models.acoustic.cast` (the control); the
activations stay float32."""

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
class BigVGANConfig:
    """The generator's layer list (the configuration's ``vocoder_bigvgan``
    section), with AMPBlock1 and the anti-aliased SnakeBeta the only block
    and activation."""

    upsample_initial_channel: int = 1536
    upsample_rates: tuple = (5, 3, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (10, 6, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    def __post_init__(self):
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, _tuples(getattr(self, f.name)))

    @property
    def row_samples(self) -> int:
        """Output samples a conditioning row."""
        return math.prod(self.upsample_rates)

    @property
    def halo_rows(self) -> int:
        """Rows on either side that one input row reaches: input row 0
        pushed forward through every layer (each activation reaching 5
        samples either side), the output samples it moves read as rows."""
        lo, hi = -3, 3                                      # conv_pre
        for u, k in zip(self.upsample_rates, self.upsample_kernel_sizes):
            p = (k - u) // 2
            lo, hi = lo * u - p, hi * u - p + k - 1         # transposed
            r = max(sum(5 + d * (kr - 1) // 2 + 5 + (kr - 1) // 2
                        for d in ds)
                    for kr, ds in zip(self.resblock_kernel_sizes,
                                      self.resblock_dilation_sizes))
            lo, hi = lo - r, hi + r                         # AMP blocks
        lo, hi = lo - 5 - 3, hi + 5 + 3         # activation_post, conv_post
        return max(-(lo // self.row_samples), hi // self.row_samples)


def kaiser_sinc() -> torch.Tensor:
    """BigVGAN's ``kaiser_sinc_filter1d(cutoff=0.25, half_width=0.3,
    kernel_size=12)``, float32: times -5.5 ... 5.5, window beta
    0.1102 (A - 8.7) for A = 2.285 * 5 * pi * 4 * 0.3 + 7.95."""
    A = 2.285 * 5 * math.pi * (4 * 0.3) + 7.95
    w = torch.kaiser_window(12, periodic=False, beta=0.1102 * (A - 8.7))
    t = torch.arange(-6, 6, dtype=torch.float32) + 0.5
    f = 2 * 0.25 * w * torch.sinc(2 * 0.25 * t)
    return f / f.sum()


class SnakeBeta(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(ch))
        self.beta = nn.Parameter(torch.zeros(ch))


def act(x: torch.Tensor, snake: SnakeBeta) -> torch.Tensor:
    """The anti-aliased SnakeBeta of [B, C, T], float32."""
    C = x.shape[1]
    f = kaiser_sinc().to(x.device).expand(C, 1, 12)
    y = 2 * Fn.conv_transpose1d(Fn.pad(x, (5, 5), mode="replicate"), f,
                                stride=2, groups=C)[..., 15:-15]
    alpha = torch.exp(snake.alpha)[:, None]
    beta = torch.exp(snake.beta)[:, None]
    v = y + torch.sin(alpha * y) ** 2 / (beta + 1e-9)
    return Fn.conv1d(Fn.pad(v, (5, 6), mode="replicate"), f, stride=2,
                     groups=C)


class AMPBlock1(nn.Module):
    def __init__(self, ch: int, k: int, dilations: tuple):
        super().__init__()
        self.dilations = dilations
        self.convs1 = nn.ModuleList(nn.Conv1d(ch, ch, k) for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(ch, ch, k) for _ in dilations)
        self.activations = nn.ModuleList(SnakeBeta(ch)
                                         for _ in range(2 * len(dilations)))


def _conv(x, layer: nn.Conv1d, dtype, dilation: int = 1):
    k = layer.weight.shape[-1]
    pad = dilation * (k - 1) // 2
    y = Fn.conv1d(cast(Fn.pad(x, (pad, pad)), dtype),
                  cast(layer.weight, dtype), dilation=dilation).float()
    if layer.bias is None:
        return y
    return y + cast(layer.bias, dtype).float()[:, None]


def _up(x, layer: nn.ConvTranspose1d, u: int, dtype):
    k = layer.weight.shape[-1]
    L = x.shape[-1]
    y = Fn.conv_transpose1d(cast(x, dtype), cast(layer.weight, dtype),
                            stride=u, padding=(k - u) // 2)
    return y.float()[..., : L * u] + cast(layer.bias, dtype).float()[:, None]


class Generator(nn.Module):
    """[B, T, D_in] conditioning rows -> [B, T * row_samples] waveform,
    float32 (tensor names as the program's module names them)."""

    def __init__(self, cfg: BigVGANConfig, d_in: int):
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
                self.resblocks.append(AMPBlock1(c_out, kr, ds))
        c_n = C >> len(cfg.upsample_rates)
        self.activation_post = SnakeBeta(c_n)
        self.conv_post = nn.Conv1d(c_n, 1, 7, bias=False)

    def forward(self, c: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        x = _conv(c.transpose(1, 2).float(), self.conv_pre, dtype)
        n = len(self.cfg.resblock_kernel_sizes)
        for i, u in enumerate(self.cfg.upsample_rates):
            x = _up(x, self.ups[i], u, dtype)
            outs = []
            for rb in self.resblocks[i * n: (i + 1) * n]:
                h = x
                for m, (d, c1, c2) in enumerate(zip(rb.dilations, rb.convs1,
                                                    rb.convs2)):
                    t = _conv(act(h, rb.activations[2 * m]), c1, dtype, d)
                    h = h + _conv(act(t, rb.activations[2 * m + 1]), c2,
                                  dtype)
                outs.append(h)
            x = torch.stack(outs).sum(0) / n
        y = _conv(act(x, self.activation_post), self.conv_post, dtype)
        return torch.clamp(y[:, 0], -1.0, 1.0)

    def layers(self) -> dict[str, nn.Module]:
        """Every conv by its module name, in the published order."""
        return {n: m for n, m in self.named_modules()
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))}

    def snakes(self) -> dict[str, SnakeBeta]:
        """Every activation by its module name, in the published order."""
        return {n: m for n, m in self.named_modules()
                if isinstance(m, SnakeBeta)}
