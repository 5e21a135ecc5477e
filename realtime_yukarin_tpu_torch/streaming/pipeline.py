"""The streaming step (PyTorch port of ``streaming/pipeline.py``).

One chunk in, one chunk out: analysis of the newly final frames (the rest
come from the carry's caches), stage-1 conversion through per-layer conv
caches, F0 moment matching, mel-cepstrum decode, stage-2 super-resolution
and the harmonic+noise renderer.  The three hand-written CUDA kernels of
this path (power spectrum, envelope cepstrum, harmonic bank) run once per
step each.  PyTorch runs eagerly; the step is a plain function of
(params, carry, chunk) returning (output, next carry).

Noise determinism: each frame's gaussian drivers are a fixed function of
the global frame index (a table row read through a per-stream
permutation, see :func:`frame_noise`), so streamed and offline synthesis
use identical noise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp.envelope import power_spectrogram
from realtime_yukarin_tpu_torch.dsp.f0 import (f0_raw_and_candidates,
                                               viterbi_snap, voicing_revision)
from realtime_yukarin_tpu_torch.dsp.framing import median3
from realtime_yukarin_tpu_torch.dsp.mcep import decode_mcep
from realtime_yukarin_tpu_torch.dsp.synthesis import synthesize
from realtime_yukarin_tpu_torch.dsp.world import analyze_given_f0
from realtime_yukarin_tpu_torch.models.acoustic import convert_mc_streamed
from realtime_yukarin_tpu_torch.models.super_resolution import (
    refine_envelope)
from realtime_yukarin_tpu_torch.models.voice_changer import (compute_dtype,
                                                             convert_f0_stats)
from realtime_yukarin_tpu_torch.ops.dft import device_const
from realtime_yukarin_tpu_torch.streaming.state import (StreamCarry,
                                                        StreamGeometry,
                                                        noise_bins)

NOISE_TABLE_FRAMES = 4096   # ~20 s of excitation before the table wraps
_NOISE_TABLE_SEED = 0x5EED


def resolve_device(device=None) -> torch.device:
    """The entry points' device: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for and absent; never falls back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the port on the CPU")
    return device


@functools.lru_cache(maxsize=4)
def _noise_table_np(bins: int) -> np.ndarray:
    rng = np.random.default_rng(_NOISE_TABLE_SEED)
    return rng.standard_normal(
        (NOISE_TABLE_FRAMES, bins, 2)).astype(np.float32)


def noise_key_from_bits(bits) -> tuple[int, int, int]:
    """(offset, stride, shift) from three unsigned 32-bit words, by the JAX
    package's formulas; stride and shift are odd, so with the power-of-two
    table they are full-cycle permutations."""
    T = NOISE_TABLE_FRAMES
    b0, b1, b2 = (int(b) for b in bits)
    return b0 % T, (b1 % (T // 2)) * 2 + 1, (b2 % (T // 2)) * 2 + 1


def noise_key_from_seed(seed: int) -> tuple[int, int, int]:
    """A stream's noise permutation from an integer seed (numpy)."""
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, size=3,
                                                dtype=np.uint64)
    return noise_key_from_bits(bits)


def frame_noise(noise_key: tuple[int, int, int], start_frame: int,
                count: int, bins: int, like: torch.Tensor) -> torch.Tensor:
    """Noise for global frames [start, start+count) -> [count, bins, 2].

    Frame i's gaussians are table row (pos*stride + offset + block*shift)
    mod T with pos = i mod T and block = floor(i / T) mod T (floor
    semantics: the first frames of a stream are negative)."""
    offset, stride, shift = noise_key
    T = NOISE_TABLE_FRAMES
    table = device_const(_noise_table_np, bins, like=like)
    gpos = start_frame + torch.arange(count, dtype=torch.int64,
                                      device=like.device)
    pos = torch.remainder(gpos, T)
    block = torch.remainder(torch.div(gpos, T, rounding_mode="floor"), T)
    idx = torch.remainder(pos * stride + offset + block * shift, T)
    return table[idx]


def streaming_step(params: dict, carry: StreamCarry, chunk: torch.Tensor,
                   noise_key: tuple[int, int, int], cfg: Config,
                   use_sr: bool = True) -> tuple[torch.Tensor, StreamCarry]:
    """One chunk in, one chunk out (constant D-frame latency), dsp mode.

    chunk: [chunk_samples] new input PCM on the carry's device.  Returns
    converted PCM [chunk_samples] and the next carry."""
    geo = StreamGeometry.from_config(cfg, use_sr)
    dsp = cfg.dsp
    hop = dsp.hop
    Fc = geo.chunk_frames
    mctx = geo.model_ctx

    # 1. roll the wave buffer and append the new chunk
    buf = torch.cat([carry.wave_buf[geo.chunk_samples:],
                     chunk.to(carry.wave_buf)])

    # 2. analyse ONLY the newly final frames; raw F0 also for the E
    # trailing provisional frames, and the El raws before them come from
    # the carry
    C = geo.cache_frames
    E = geo.f0_edge
    El = geo.f0_left
    off = geo.buf_frame0_offset + C * hop
    raw_fresh, cand_fresh, cost_fresh = f0_raw_and_candidates(
        buf, geo.fresh_frames, dsp, off)
    raw_ext = torch.cat([carry.f0_raw_prev, raw_fresh])
    cand_ext = torch.cat([carry.f0_cand_prev, cand_fresh])
    cost_ext = torch.cat([carry.f0_cost_prev, cost_fresh])
    m_ext = median3(raw_ext)
    hl = dsp.f0_snap_left_eff
    hr = dsp.f0_snap_halo
    lo = El - hl                                  # m_ext index of frame C-hl
    win = slice(lo, lo + Fc + hl + hr)
    snapped, choice = viterbi_snap(m_ext[win], cand_ext[win], cost_ext[win],
                                   dsp)
    # ONE power spectrogram (one kernel launch) for voicing revision,
    # refinement, envelope and aperiodicity
    P = power_spectrogram(buf, Fc, dsp, off)
    f0_final = voicing_revision(buf, snapped[hl: hl + Fc],
                                choice[hl: hl + Fc], Fc, dsp, off, P=P)
    ffresh = analyze_given_f0(buf, f0_final, Fc, dsp, off, refine=True, P=P)

    f0_all = torch.cat([carry.f0_cache, ffresh.f0])           # [Fn - E]
    mc_all = torch.cat([carry.mc_cache, ffresh.mc])
    ap_all = torch.cat([carry.ap_cache, ffresh.ap])

    # 3. convert: stage 1 advances by the Fc newly final input frames via
    # its per-layer caches; its outputs (lagging c1 frames) extend the
    # carried stage-1 output cache to the range SR + synthesis need
    ctx_sr = cfg.super_resolution.context_frames if use_sr else 0
    c1 = cfg.acoustic.context_frames
    dtype = compute_dtype(cfg)
    Fn = geo.analysis_frames
    L = Fc + 1
    s = mctx                                  # first frame synthesis reads
    res, stage1_acts = convert_mc_streamed(
        params["stage1"], mc_all[Fn - E - Fc: Fn - E],
        f0_all[Fn - E - Fc: Fn - E], carry.stage1_acts, cfg.acoustic, dtype)
    mc_c_fresh = mc_all[Fn - E - c1 - Fc: Fn - E - c1] + res
    mc_c_need = torch.cat([carry.mc_c_cache, mc_c_fresh])
    f0c_need = convert_f0_stats(f0_all[c1 + E: Fn - c1 - E],
                                params["f0_stats"])
    env_low = decode_mcep(mc_c_need, dsp)
    if use_sr:
        env_mid = refine_envelope(params["stage2"], env_low,
                                  cfg.super_resolution, dsp, dtype)
    else:
        env_mid = env_low

    # 4. synthesize Fc frames with position-deterministic noise
    noise = frame_noise(noise_key, carry.frame_pos, Fc, noise_bins(cfg),
                        like=buf)
    out, synth_carry = synthesize(f0c_need[ctx_sr: ctx_sr + L],
                                  env_mid[ctx_sr: ctx_sr + L],
                                  ap_all[s: s + L], noise, dsp, carry.synth)

    new_carry = StreamCarry(
        wave_buf=buf, synth=synth_carry, frame_pos=carry.frame_pos + Fc,
        mc_c_cache=mc_c_need[Fc:], stage1_acts=stage1_acts,
        f0_cache=f0_all[Fc:], mc_cache=mc_all[Fc:], ap_cache=ap_all[Fc:],
        f0_raw_prev=raw_ext[Fc: Fc + El],
        f0_cand_prev=cand_ext[Fc: Fc + El],
        f0_cost_prev=cost_ext[Fc: Fc + El])
    return out, new_carry


def init_stream(params: dict, cfg: Config, use_sr: bool = True, device=None
                ) -> tuple[StreamCarry, StreamGeometry]:
    """Initial carry (on ``device``, ``cuda`` by default) and geometry of
    the dsp vocoder mode (``cfg.resolved_vocoder_mode`` must be "dsp": the
    ddsp and wave vocoders are not wired into streaming yet, ROADMAP.md
    queue item 9)."""
    if cfg.resolved_vocoder_mode != "dsp":
        raise NotImplementedError(
            f"vocoder mode {cfg.resolved_vocoder_mode!r} is not wired into "
            f"streaming yet (ROADMAP.md queue item 9); the port streams "
            f"'dsp'")
    device = resolve_device(device)
    geo = StreamGeometry.from_config(cfg, use_sr)
    return StreamCarry.init(cfg, geo, params, device), geo
