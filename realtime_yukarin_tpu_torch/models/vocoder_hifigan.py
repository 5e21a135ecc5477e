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
[t·hop, (t + 1)·hop).

A streamed step keeps the samples of its centre frames alone (the halo of
``context_frames`` on each side is read, not kept), so each layer runs over
the rows those samples depend on, no more: ``VocoderHiFiGANConfig.cone``
walks the layer list backward from the kept samples, as ``context_frames``
does, and clamps each range to the window's rows.  conv_pre runs over the
input rows the cone reads, each transposed conv over the previous stage's
rows that it reads, each stage's resblocks over its rows of that output,
SAME-padded (the padding of a slice's edge reaches no row read on), and
conv_post over the kept samples and its 3 taps each side: at the published
widths and a 21-frame halo 268 / 583 / 1,384 / 2,526 rows of a window's
315 / 1,260 / 3,780 / 7,560 at stages 1-4.  The tails keep those windows
(conv_pre's act and each stage's up and mean, by a start row and a
length), so no copy is made.  Without ``out_ctx`` the cone is the whole
window; offline (``out_ctx`` 0) it leaves out only late rows of the last
frame, whose samples are not kept.  The arithmetic of each kept sample is
the whole window's.

Channels-last inside: the activations are [B, T, C] from the frame-major
input [..., T, D_in] to conv_post, and every convolution runs on a
[B, C, 1, T] view of them whose memory is NHWC, against weights laid out
channels-last once per generator and compute dtype (:meth:`packed`), with
no bias.  What lies between two convolutions (the bias, the crop, the
residual add, the resblocks' mean, the leaky ReLU) is one pass of
``ops/hifigan_tail.py`` (the CUDA kernel ``csrc/hifigan_tail.cu`` on the
card): 1 + 19 a stage at the published widths.  Kernels and activations
in the compute dtype (bfloat16 on the default path), biases and the tails'
arithmetic in float32, the output in float32 (or float64, for a float64
witness).  Inference only: the port trains no generator.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from realtime_yukarin_tpu_torch.config import DspConfig, VocoderHiFiGANConfig
from realtime_yukarin_tpu_torch.models.vocoder_nn import (vocoder_input_dim,
                                                          vocoder_inputs)
from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.ops.hifigan_tail import hifigan_tail

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01       # the generator's last activation: torch's default


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> the [B, C, 1, T] view of the same memory (NHWC)."""
    return x.transpose(1, 2).unsqueeze(2)


def _btc(y: torch.Tensor) -> torch.Tensor:
    """A convolution's [B, C, 1, T] output -> its [B, T, C] view, which
    is contiguous when the output is NHWC in memory, as the tails
    require."""
    return y.squeeze(2).transpose(1, 2)


def _conv(x: torch.Tensor, w: torch.Tensor, dilation: int = 1
          ) -> torch.Tensor:
    """SAME-padded conv of [B, T, C_in] by ``w`` [C_out, C_in, 1, k]
    (channels-last, odd k), no bias: [B, T, C_out]."""
    k = w.shape[-1]
    return _btc(Fn.conv2d(_nhwc(x), w, padding=(0, dilation * (k - 1) // 2),
                          dilation=(1, dilation)))


def _conv_up(x: torch.Tensor, w: torch.Tensor, u: int) -> torch.Tensor:
    """Transposed conv of stride u of [B, L, C_in] by ``w`` [C_in, C_out,
    1, k] (channels-last), no bias: [B, u·L (+ 1 for odd u), C_out]."""
    k = w.shape[-1]
    return _btc(Fn.conv_transpose2d(_nhwc(x), w, stride=(1, u),
                                    padding=(0, (k - u) // 2)))


class Packed(NamedTuple):
    """A generator's weights as its channels-last forward reads them, in
    one compute dtype: each conv as (weight [C_out, C_in, 1, k], or [C_in,
    C_out, 1, k] for a transposed one, channels-last in the compute dtype;
    bias [C_out] in float32, or float64 for a float64 witness).  ``blocks``
    is by stage, then resblock, then dilation: (c1's weight and bias,
    c2's)."""
    pre: tuple
    ups: tuple
    blocks: tuple
    post: tuple


class ResBlock1(nn.Module):
    """V1's residual block: per dilation d a dilated k-tap conv and a plain
    one, each after a leaky ReLU, added to the input.  Holds the weights;
    :class:`HiFiGANGenerator` runs it channels-last."""

    def __init__(self, channels: int, kernel: int, dilations: tuple):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel)
                                    for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel)
                                    for _ in dilations)


def _resblock(x: torch.Tensor, xa: torch.Tensor, layers: tuple,
              dilations: tuple, acc: torch.Tensor | None, n: int,
              slope: float, keep: tuple | None) -> torch.Tensor:
    """One ResBlock1 over x (xa = lrelu(x, 0.1)), channels-last: its output
    added to the stage's sum ``acc`` (in place, or a new sum for the first
    block), or, for the stage's last block (``keep``: the (start, length)
    of the rows the next conv reads), lrelu(sum / n, slope) over those
    rows."""
    for m, (d, (w1, b1, w2, b2)) in enumerate(zip(dilations, layers)):
        (t,) = hifigan_tail("act", _conv(xa, w1, d), b1, slope=LRELU_SLOPE)
        v = _conv(t, w2)
        if m < len(dilations) - 1:
            x, xa = hifigan_tail("res", v, b2, r=x, slope=LRELU_SLOPE)
        elif keep is not None:
            start, length = keep
            return hifigan_tail("mean", v, b2, r=x, acc=acc, slope=slope,
                                divisor=float(n), start=start,
                                length=length)[0]
        else:
            return hifigan_tail("sum", v, b2, r=x, acc=acc)[0]


class HiFiGANGenerator(nn.Module):
    """Conditioning [..., T, D_in] -> waveform [..., T * hop] (float32), or
    with ``out_ctx`` the samples of frames [out_ctx, T - out_ctx - 1)
    alone (:func:`hifigan_vocode`'s), each layer run over the rows those
    samples depend on (``VocoderHiFiGANConfig.cone``).

    ``forward(x, dtype, mark, out_ctx)`` calls ``mark("vocoder_s<i>")``
    before upsampling stage i (1-based) and ``mark("vocoder")`` before
    conv_post: the stage markers of ``utils/profiling.py``.

    The skeleton of both generators: the cone, the convolutions and the
    markers are :meth:`forward`'s; what lies between two convolutions is
    the hooks' (``_pre_tail``, ``_up_tail``, ``_stage``, ``_post_tail``),
    which ``models/vocoder_bigvgan.py`` overrides, with the block
    (``BLOCK``) and conv_post's bias (``POST_BIAS``).  A conditioning row
    spans ``frames_per_row`` frames (:meth:`_condition`)."""

    ZERO_INIT = ()
    BLOCK = ResBlock1
    POST_BIAS = True

    def __init__(self, cfg: VocoderHiFiGANConfig, dsp_cfg: DspConfig):
        super().__init__()
        self.cfg = cfg
        self.hop = dsp_cfg.hop
        self.frames_per_row = cfg.frames_per_row(dsp_cfg.hop)
        C = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(vocoder_input_dim(dsp_cfg), C, 7)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(C // 2 ** i, cfg.channels(i), k, u)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                           cfg.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            self.BLOCK(cfg.channels(i), k, ds)
            for i in range(len(cfg.upsample_rates))
            for k, ds in zip(cfg.resblock_kernel_sizes,
                             cfg.resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(cfg.channels(len(cfg.upsample_rates) - 1),
                                   1, 7, bias=self.POST_BIAS)
        # dtype -> (the parameters' key, Packed, the tensors it holds)
        self._packed: dict = {}

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

    def packed(self, dtype: torch.dtype) -> Packed:
        """The weights laid out for the forward in ``dtype``: made once,
        and again only when a parameter is replaced or written in place
        (keyed by each one's storage and version; the entry keeps the
        parameters' storage alive, so no new tensor can reuse an address
        the key holds).  Held by a CUDA graph captured around the call."""
        params = [p.detach() for p in self.parameters()]
        key = [(p.data_ptr(), p._version) for p in params]
        entry = self._packed.get(dtype)
        if entry is None or entry[0] != key:
            held = list(params)

            def keep(*tensors):
                held.extend(t for t in tensors if t is not None)
                return tensors
            entry = self._packed[dtype] = key, self._pack(dtype, keep), held
        cuda.hold(*entry[2])
        return entry[1]

    def _pack(self, dtype: torch.dtype, keep: Callable) -> Packed:
        """:meth:`packed`'s layout; every tensor it makes goes through
        ``keep``, which holds it."""
        bias_dtype = torch.promote_types(dtype, torch.float32)

        def conv(layer):
            w = layer.weight.detach().to(dtype).unsqueeze(2)
            b = layer.bias
            return keep(w.contiguous(memory_format=torch.channels_last),
                        None if b is None
                        else b.detach().to(bias_dtype).contiguous())
        n = len(self.cfg.resblock_kernel_sizes)
        blocks = tuple(
            tuple(tuple(conv(c1) + conv(c2)
                        for c1, c2 in zip(rb.convs1, rb.convs2))
                  for rb in self.resblocks[i * n: (i + 1) * n])
            for i in range(len(self.ups)))
        return Packed(conv(self.conv_pre), tuple(conv(up) for up in self.ups),
                      blocks, conv(self.conv_post))

    @torch.no_grad()
    def forward(self, x: torch.Tensor, dtype=torch.float32,
                mark: Callable[[str], None] | None = None,
                out_ctx: int | None = None) -> torch.Tensor:
        lead, (T, D) = x.shape[:-2], x.shape[-2:]
        mark = mark or (lambda stage: None)
        w = self.packed(dtype)
        # each tail keeps the next range's rows of its conv's output, from
        # that range's first row less the first row the output holds
        (lo, hi), *cone = self.cfg.cone(T, out_ctx, self.hop)
        a = self._pre_tail(
            _conv(self._condition(x.reshape(-1, T, D), lo, hi).to(dtype),
                  w.pre[0]), w, cone[0][0] - lo, _rows(cone[0]))
        rates = self.cfg.upsample_rates
        for i, u in enumerate(rates):
            mark(f"vocoder_s{i + 1}")
            (lo, _), rows, out = cone[2 * i: 2 * i + 3]
            h, a = self._up_tail(_conv_up(a, w.ups[i][0], u), w, i,
                                 rows[0] - lo * u, _rows(rows))
            last = i + 1 == len(rates)
            out = cone[-2] if last else out
            a = self._stage(h, a, w, i, (out[0] - rows[0], _rows(out)), last)
        mark("vocoder")
        (lo, _), keep = cone[-2:]
        y = _conv(a, w.post[0])[:, keep[0] - lo: keep[1] - lo]
        return self._post_tail(y, w).reshape(*lead, _rows(keep))

    def _condition(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Conditioning rows [lo, hi) of frames x [B, T, D]: a row the mean
        of its ``frames_per_row`` frames (one: the frame itself)."""
        r = self.frames_per_row
        if r == 1:
            return x[:, lo: hi]
        B, _, D = x.shape
        return x[:, lo * r: hi * r].reshape(B, hi - lo, r, D).mean(2)

    def _pre_tail(self, y, w: Packed, start: int, length: int):
        """conv_pre's output to the first transposed conv's input."""
        return hifigan_tail("act", y, w.pre[1], slope=LRELU_SLOPE,
                            start=start, length=length)[0]

    def _up_tail(self, y, w: Packed, i: int, start: int, length: int):
        """Stage i's transposed conv output to (its rows, the first
        resblock conv's input)."""
        return hifigan_tail("up", y, w.ups[i][1], slope=LRELU_SLOPE,
                            start=start, length=length)

    def _stage(self, h, a, w: Packed, i: int, keep: tuple, last: bool):
        """Stage i's resblocks over its rows ``h`` (``a`` their
        activation): the next conv's input over ``keep`` (start, length)."""
        n = len(self.cfg.resblock_kernel_sizes)
        slope = POST_SLOPE if last else LRELU_SLOPE
        acc = None
        for j, (layers, ds) in enumerate(zip(
                w.blocks[i], self.cfg.resblock_dilation_sizes)):
            acc = _resblock(h, a, layers, ds, acc, n, slope,
                            keep if j == n - 1 else None)
        return acc

    def _post_tail(self, y, w: Packed) -> torch.Tensor:
        """conv_post's kept samples to the waveform."""
        y = y.to(torch.promote_types(y.dtype, torch.float32)) + w.post[1]
        return torch.tanh(y)


def _rows(r: tuple) -> int:
    return r[1] - r[0]


def hifigan_vocode(net: HiFiGANGenerator, f0, mc, ap, dtype=torch.float32,
                   out_ctx: int = 0,
                   mark: Callable[[str], None] | None = None
                   ) -> torch.Tensor:
    """The generator over frame-major features ([..., T] f0, [..., T, M+1]
    mc, [..., T, B] ap, ``vocoder_inputs``' conditioning), keeping the
    samples of frames [out_ctx, T - out_ctx - 1): rows are F + 1 +
    2·out_ctx (the renderer's F + 1 plus the halo on each side; 0
    offline).  Returns [..., F * hop]."""
    return net(vocoder_inputs(f0, mc, ap), dtype, mark, out_ctx)
