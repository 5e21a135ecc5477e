"""The yardstick's arithmetic, from the configuration's shapes alone: the
learned stages' FLOPs, the least time of a kernel's work (its roofline),
and the card's published peaks.  Nothing here reads the program.

FLOPs count 2 per multiply-add.  A convolution counts the taps over its
SAME padding, as ``torch.utils.flop_counter`` does.
"""

from __future__ import annotations

import math

from benchmark.reference.dsp.primitives import noise_fft_size

# NVIDIA H100 SXM, dense, at its 700 W power limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def least_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least time the card could take for the work: the larger of its
    operations over the peak rate and its bytes over HBM bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def _glu_stack(T: int, d_in: int, hidden: int, blocks: int, k: int,
               d_out: int) -> int:
    """Stage 1 over T output frames: 1x1 stem, blocks of a k-tap gated
    conv (hidden -> 2 hidden) and a 1x1 projection, 1x1 head."""
    return (2 * T * d_in * hidden
            + blocks * (2 * T * k * hidden * 2 * hidden
                        + 2 * T * hidden * hidden)
            + 2 * T * hidden * d_out)


def stage1_flops(cfg, frames: int) -> int:
    """Stage 1 (``models/acoustic.py``) producing ``frames`` frames."""
    a, d = cfg.acoustic, cfg.dsp
    d_in = d.mc_dim + (2 if a.use_f0_input else 0)
    return _glu_stack(frames, d_in, a.hidden, a.num_blocks, a.kernel_size,
                      d.mc_dim)


def sr_flops(cfg, frames: int) -> int:
    """Stage 2 (``models/super_resolution.py``) over ``frames`` frames:
    dense in, blocks of a k-tap time conv (h -> 2h) and a dense mix,
    dense head."""
    s, K = cfg.super_resolution, cfg.dsp.spec_bins
    h = s.hidden
    return (2 * frames * K * h
            + s.num_blocks * (2 * frames * s.kernel_size * h * 2 * h
                              + 2 * frames * h * h)
            + 2 * frames * h * K)


def serve_learned_flops(cfg, geo, mode: str = "dsp") -> int:
    """Learned FLOPs of one lane's streaming step: stage 1 over the chunk's
    fresh frames (its caches hold the rest), stage 2 over the stage-1
    cache frames and the chunk.  The dsp renderer has none."""
    if mode != "dsp":
        raise NotImplementedError(f"learned FLOPs of vocoder {mode!r}")
    Fc = geo.chunk_frames
    return stage1_flops(cfg, Fc) + sr_flops(cfg, geo.stage1_cache_frames
                                            + Fc)


def train_forward_flops(cfg, batch: int, crop: int) -> int:
    """Forward FLOPs of the learned stacks the joint objective trains, for
    ``batch`` rows of ``crop`` + 1 frames: stage 1, stage 2, the DDSP
    control net (1x1 stem, k-tap h -> h blocks, heads to H harmonics and
    the noise bins) and the wave decoder (the same trunk; its heads over
    the ``crop`` output frames)."""
    d, T = cfg.dsp, crop + 1
    d_voc = d.mc_dim + d.num_ap_bands + 2
    v = cfg.vocoder_nn
    k_noise = noise_fft_size(d.hop) // 2 + 1
    ddsp = (2 * T * d_voc * v.hidden
            + v.num_blocks * 2 * T * v.kernel_size * v.hidden ** 2
            + 2 * T * v.hidden * (d.num_harmonics + k_noise))
    w = cfg.vocoder_wave
    k_res = k_noise
    tracks = w.phase_harmonics + w.phase_fractional
    wave = (2 * T * d_voc * w.hidden
            + w.num_blocks * 2 * T * w.kernel_size * w.hidden ** 2
            + 2 * crop * w.hidden * (2 * k_res + 2 * tracks * k_res))
    return batch * (stage1_flops(cfg, T) + sr_flops(cfg, T) + ddsp + wave)


def rfft_flops(n: int) -> float:
    """A real FFT of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def analysis_least_s(cfg, rows: int) -> float:
    """Kernels 2-3's work for ``rows`` frames at the least it can be: four
    real transforms of n points per row (the power spectrum's, and the
    envelope cepstrum's three), the elementwise work not counted; bytes
    are the frames, the window, P and the output, each moved once, with
    no bases."""
    n = cfg.dsp.fft_size
    K = n // 2 + 1
    flops = rows * 4 * rfft_flops(n)
    nbytes = 4 * (rows * n + n + 2 * rows * K)
    return least_s(flops, nbytes)


def bank_forward_cost(R: int, H: int, hop: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the harmonic bank's forward: per row, sample and
    harmonic two multiply-adds (the left and right sums) and the
    recurrence's, 6 FLOP; aL, aR, phi, frac and the output moved once."""
    return 6 * R * hop * H, 4 * (2 * R * H + 2 * R * hop + hop)


def bank_backward_cost(R: int, H: int, hop: int, phase: bool = True
                       ) -> tuple[int, int]:
    """(FLOPs, bytes) of the bank's backward.  All four outputs: 14 FLOP
    per row, sample and harmonic; d_aL and d_aR only: 6.  Each input and
    output moved once."""
    if phase:
        return 14 * R * hop * H, 4 * (4 * R * H + 4 * R * hop + hop)
    return 6 * R * hop * H, 4 * (4 * R * H + 2 * R * hop + hop)
