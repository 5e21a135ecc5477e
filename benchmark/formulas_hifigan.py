"""The neural vocoders' arithmetic, from the configuration's shapes alone:
each HiFi-GAN V1 generator layer's FLOPs and bytes at a tick's rows, its
least time, and the learned FLOPs of one lane's streaming step in every
vocoder mode.  Nothing here reads the program.

FLOPs count 2 per multiply-add, a convolution's taps on its SAME padding
included and a transposed convolution's every tap (before the crop), as
``torch.utils.flop_counter`` counts them.  Bytes are a fused layer's least
traffic in bfloat16: its input read once (a resblock's second conv also
reads the residual it adds to), its output written once and its weights
and bias read once a tick; the activations and the resblocks' mean ride in
those reads and writes.
"""

from __future__ import annotations

from benchmark.formulas import (PEAK_BF16_FLOPS, least_s, serve_learned_flops,
                                stage1_flops)
from benchmark.reference.dsp.primitives import noise_fft_size

BF16 = 2


def _conv(name, lanes, L_in, L_out, c_in, c_out, k, taps_at, extra_in=0):
    flops = 2 * lanes * taps_at * k * c_in * c_out
    nbytes = BF16 * (lanes * (c_in * L_in + c_out * L_out + extra_in)
                     + c_in * c_out * k + c_out)
    return name, flops, nbytes


def generator_layers(h, d_in: int, lanes: int, frames: int
                     ) -> list[tuple[str, int, int]]:
    """[(layer, FLOPs, bytes)] of the generator over ``frames`` frames of
    ``lanes`` lanes, in the order it runs: ``conv_pre``, then per stage i
    (1-based) ``s<i>.up`` and its resblocks' convs ``s<i>.rb<j>.c<1|2>_<m>``,
    then ``conv_post``.  ``h`` is the ``vocoder_hifigan`` section
    (``reference/models/vocoder_hifigan.py:HiFiGANConfig``)."""
    C = h.upsample_initial_channel
    T = frames
    out = [_conv("conv_pre", lanes, T, T, d_in, C, 7, T)]
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes), start=1):
        c = C // 2
        out.append(_conv(f"s{i}.up", lanes, T, u * T, C, c, k, T))
        T, C = u * T, c
        for j, (kr, ds) in enumerate(zip(h.resblock_kernel_sizes,
                                         h.resblock_dilation_sizes)):
            for m, _ in enumerate(ds):
                out.append(_conv(f"s{i}.rb{j}.c1_{m}", lanes, T, T, C, C,
                                 kr, T))
                out.append(_conv(f"s{i}.rb{j}.c2_{m}", lanes, T, T, C, C,
                                 kr, T, extra_in=C * T))
    out.append(_conv("conv_post", lanes, T, T, C, 1, 7, T))
    return out


def generator_flops(h, d_in: int, lanes: int, frames: int) -> int:
    return sum(f for _, f, _ in generator_layers(h, d_in, lanes, frames))


def generator_least_s(h, d_in: int, lanes: int, frames: int) -> float:
    """The generator's least time: each layer's larger of FLOPs over the
    bf16 peak and bytes over HBM bandwidth, summed."""
    return sum(least_s(f, b, PEAK_BF16_FLOPS)
               for _, f, b in generator_layers(h, d_in, lanes, frames))


def stage_of(layer: str) -> str:
    """The profiling stage a layer runs in: ``vocoder_s<i>`` for stage i's,
    ``vocoder`` for conv_pre and conv_post."""
    return f"vocoder_s{layer[1]}" if layer.startswith("s") else "vocoder"


def vocoder_input_dim(cfg) -> int:
    """mc, band aperiodicity, log F0 and the voiced flag."""
    d = cfg.dsp
    return d.mc_dim + d.num_ap_bands + 2


def control_net_flops(cfg, rows: int) -> int:
    """The DDSP control net over ``rows`` frames: 1x1 stem, k-tap h -> h
    blocks, heads to H harmonics and the noise bins."""
    d, v = cfg.dsp, cfg.vocoder_nn
    k_noise = noise_fft_size(d.hop) // 2 + 1
    return (2 * rows * vocoder_input_dim(cfg) * v.hidden
            + v.num_blocks * 2 * rows * v.kernel_size * v.hidden ** 2
            + 2 * rows * v.hidden * (d.num_harmonics + k_noise))


def wave_decoder_flops(cfg, rows: int, out_rows: int) -> int:
    """The wave decoder: its trunk over ``rows`` frames, its heads and the
    phase combs' sums over the ``out_rows`` it renders."""
    d, w = cfg.dsp, cfg.vocoder_wave
    K = noise_fft_size(d.hop) // 2 + 1
    tracks = w.phase_harmonics + w.phase_fractional
    return (2 * rows * vocoder_input_dim(cfg) * w.hidden
            + w.num_blocks * 2 * rows * w.kernel_size * w.hidden ** 2
            + 2 * out_rows * w.hidden * (2 * K + 2 * tracks * K)
            + 4 * 2 * out_rows * tracks * K)


def serve_learned_flops_mode(cfg, geo, mode: str, h=None) -> int:
    """Learned FLOPs of one lane's streaming step in vocoder ``mode``:
    stage 1 and SR as ``formulas.serve_learned_flops`` counts them (at
    ``geo``, the mode's geometry), and the vocoder over the Fc + 1 + 2 x
    its halo rows it reads.  The hifigan mode runs no SR: stage 1 and the
    generator (``h`` its layer list)."""
    base = serve_learned_flops(cfg, geo)
    Fc = geo.chunk_frames
    if mode == "dsp":
        return base
    if mode == "hifigan":
        return stage1_flops(cfg, Fc) + generator_flops(
            h, vocoder_input_dim(cfg), 1, Fc + 1 + 2 * h.halo_frames)
    if mode == "ddsp":
        return base + control_net_flops(
            cfg, Fc + 1 + 2 * cfg.vocoder_nn.context_frames)
    if mode == "wave":
        return base + wave_decoder_flops(
            cfg, Fc + 1 + 2 * cfg.vocoder_wave.context_frames, Fc)
    raise ValueError(f"no vocoder mode {mode!r}")

