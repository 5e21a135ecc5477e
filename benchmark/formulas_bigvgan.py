"""The BigVGAN v2 generator's arithmetic, from the configuration's shapes
alone: the rows each layer runs over (the dependency cone of the samples a
streamed step keeps), each layer's FLOPs and bytes at a tick's lanes, the
generator's least time, its activations' least time, and the learned
FLOPs of one lane's streaming step in the bigvgan mode.  Nothing here
reads the program.

Rows are counted from the start, over the cone: a streamed step keeps the
samples of the window's centre frames, and each layer runs over the rows
those depend on (a SAME conv's k // 2 taps, a transposed conv's taps, the
anti-aliased activation's 5 rows, on either side; each range clamped to
the window's rows).  FLOPs count 2 per multiply-add, a convolution's taps
on its SAME padding included and a transposed convolution's every tap, as
``torch.utils.flop_counter`` counts them; an activation counts
``ACT_FLOPS`` an output element (the upsample's two samples of 6 taps and
the downsample's 12, and the snake's product, square, scale and add per
upsampled sample).  Bytes, bfloat16: a convolution's input read once (a
second conv's residual too), its output written once, its weights and bias
once a tick (the passes between two convolutions ride in those); an
activation pass its operands read once, its results written once and its
bias, alpha and 1 / beta.

The passes between two convolutions of the program's design
(``csrc/bigvgan_act.cu`` where an activation follows, ``csrc/hifigan_tail.cu``
elsewhere), a stage at a time: the transposed conv's bias
with the first block's first activation (v kept); per block after the
first, its own first activation of the stage's rows; per dilation, the
first conv's bias and activation, and the second conv's bias and residual
with the next activation (v kept), but for the last dilation a running sum
or, for the stage's last block, the mean, with activation_post after the
last stage: 18 activations a stage and activation_post, 109 in all.
"""

from __future__ import annotations

from benchmark.formulas import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS,
                                PEAK_HBM_BYTES, least_s, stage1_flops)
from benchmark.formulas_hifigan import vocoder_input_dim

BF16 = 2
REACH = 5           # rows an activation reads on either side
ACT_FLOPS = 2 * (2 * 6 + 12) + 2 * 4
PAIR = 2            # frames a conditioning row


def cone(b, T: int, out_ctx: int, hop: int) -> tuple:
    """The rows each layer boundary runs over for a window of T frames of
    ``hop`` samples (T // 2 conditioning rows) whose frames [out_ctx, T -
    out_ctx - 1) are kept: half-open ranges, input first: conv_pre's input
    rows, per stage its transposed conv's input and its rows,
    activation_post's input, conv_post's input, the kept samples.  ``b``
    is the ``vocoder_bigvgan`` section (``reference/models/
    vocoder_bigvgan.py:BigVGANConfig``)."""
    n = (T // PAIR) * b.row_samples
    reach = max(sum((d + 1) * (k - 1) // 2 + 2 * REACH for d in ds)
                for k, ds in zip(b.resblock_kernel_sizes,
                                 b.resblock_dilation_sizes))

    def clamp(lo, hi, n):
        return max(lo, 0), min(hi, n)
    kept = (out_ctx * hop, (T - out_ctx - 1) * hop)
    post = clamp(kept[0] - 3, kept[1] + 3, n)
    out = [kept, post, clamp(post[0] - REACH, post[1] + REACH, n)]
    for u, k in reversed(list(zip(b.upsample_rates,
                                  b.upsample_kernel_sizes))):
        lo, hi = out[-1]
        out.append(clamp(lo - reach, hi + reach, n))
        lo, hi = out[-1]
        n //= u
        p = (k - u) // 2
        out.append(clamp(-(-(lo + p - k + 1) // u), (hi - 1 + p) // u + 1,
                         n))
    lo, hi = out[-1]
    out.append(clamp(lo - 3, hi + 3, n))
    return tuple(reversed(out))


def _conv(name, lanes, rows_in, rows_out, c_in, c_out, k, taps_at,
          extra_in=0, bias=True):
    flops = 2 * lanes * taps_at * k * c_in * c_out
    nbytes = BF16 * (lanes * (c_in * rows_in + c_out * rows_out + extra_in)
                     + c_in * c_out * k + (c_out if bias else 0))
    return name, "conv", flops, nbytes


def _pass(name, lanes, rows, C, operands, act, keep_v):
    """A pass between two convolutions: (name, "act" or "tail", FLOPs,
    bytes)."""
    n = lanes * rows * C
    outputs = (1 if act else 0) + (1 if keep_v or not act else 0)
    return (name, "act" if act else "tail", ACT_FLOPS * n if act else 0,
            BF16 * (operands + outputs) * n + 4 * C * (3 if act else 1))


def generator_layers(b, d_in: int, lanes: int, T: int, out_ctx: int,
                     hop: int) -> list[tuple[str, str, int, int]]:
    """[(layer, kind, FLOPs, bytes)] of the generator over its cone at
    ``lanes`` lanes, in the order it runs: kind "conv" for a convolution,
    "act" for a pass with an activation, "tail" for one without."""
    (a, e), *c = cone(b, T, out_ctx, hop)
    C = b.upsample_initial_channel
    rows = e - a
    out = [_conv("conv_pre", lanes, rows, rows, d_in, C, 7, rows),
           _pass("conv_pre.bias", lanes, c[0][1] - c[0][0], C, 1, False,
                 False)]
    n_blocks = len(b.resblock_kernel_sizes)
    last_stage = len(b.upsample_rates)
    for i, (u, k) in enumerate(zip(b.upsample_rates,
                                   b.upsample_kernel_sizes), start=1):
        (lo, hi), (r0, r1) = c[2 * i - 2: 2 * i]
        L, R = hi - lo, r1 - r0
        keep = c[-2] if i == last_stage else c[2 * i]
        K = keep[1] - keep[0]
        out.append(_conv(f"s{i}.up", lanes, L, R, C, C // 2, k, L))
        C //= 2
        out.append(_pass(f"s{i}.up.act", lanes, R, C, 1, True, True))
        for j, (kr, ds) in enumerate(zip(b.resblock_kernel_sizes,
                                         b.resblock_dilation_sizes)):
            if j:
                out.append(_pass(f"s{i}.rb{j}.act", lanes, R, C, 1, True,
                                 False))
            for m, _ in enumerate(ds):
                out.append(_conv(f"s{i}.rb{j}.c1_{m}", lanes, R, R, C, C,
                                 kr, R))
                out.append(_pass(f"s{i}.rb{j}.c1_{m}.act", lanes, R, C, 1,
                                 True, False))
                out.append(_conv(f"s{i}.rb{j}.c2_{m}", lanes, R, R, C, C,
                                 kr, R, extra_in=C * R))
                if m < len(ds) - 1:
                    out.append(_pass(f"s{i}.rb{j}.c2_{m}.act", lanes, R, C,
                                     2, True, True))
                elif j < n_blocks - 1:
                    out.append(_pass(f"s{i}.rb{j}.sum", lanes, R, C,
                                     2 + (j > 0), False, False))
                else:
                    out.append(_pass(f"s{i}.mean", lanes, K, C,
                                     2 + (j > 0), i == last_stage, False))
    lo, hi = c[-2]
    out.append(_conv("conv_post", lanes, hi - lo, hi - lo, C, 1, 7, hi - lo,
                     bias=False))
    return out


def generator_flops(b, d_in, lanes, T, out_ctx, hop) -> int:
    """The convolutions' and the activations' FLOPs over the cone."""
    return sum(f for *_, f, _ in generator_layers(b, d_in, lanes, T,
                                                  out_ctx, hop))


def generator_least_s(b, d_in, lanes, T, out_ctx, hop) -> float:
    """The generator's least time over its cone: per convolution the
    larger of FLOPs over the bf16 peak and bytes over HBM bandwidth, and
    per activation its FLOPs over the float32 peak (its bytes ride in the
    convolutions'), summed."""
    total = 0.0
    for _, kind, f, nbytes in generator_layers(b, d_in, lanes, T, out_ctx,
                                               hop):
        if kind == "conv":
            total += least_s(f, nbytes, PEAK_BF16_FLOPS)
        elif kind == "act":
            total += f / PEAK_F32_FLOPS
    return total


def act_least_s(b, d_in, lanes, T, out_ctx, hop) -> float:
    """The activation passes' least time (``csrc/bigvgan_act.cu``'s
    ``bigvgan_act_kernel`` launches): per pass the larger of its bytes
    over HBM bandwidth and its FLOPs over the float32 peak, summed."""
    return sum(max(nbytes / PEAK_HBM_BYTES, f / PEAK_F32_FLOPS)
               for _, kind, f, nbytes in generator_layers(
                   b, d_in, lanes, T, out_ctx, hop) if kind == "act")


def serve_learned_flops(cfg, geo, b, halo: int) -> int:
    """Learned FLOPs of one lane's streaming step in the bigvgan mode:
    stage 1 over the chunk's fresh frames and the generator over the cone
    of its Fc + 1 + 2 x ``halo`` frames (the mode runs no SR)."""
    Fc = geo.chunk_frames
    return stage1_flops(cfg, Fc) + generator_flops(
        b, vocoder_input_dim(cfg), 1, Fc + 1 + 2 * halo, halo, cfg.dsp.hop)
