"""The streaming step (PyTorch port of ``streaming/pipeline.py``).

One chunk in, one chunk out: the client chunk resampled to the internal
rate, analysis of the newly final frames (the rest come from the carry's
caches), stage-1 conversion through per-layer conv caches, F0 moment
matching, mel-cepstrum decode, stage-2 super-resolution, then the vocoder
mode's synthesis (``models/vocoders.py``) and the output resampled to the
client rate.  The three hand-written CUDA kernels of this path (power
spectrum, envelope cepstrum, harmonic bank) run once per step each.  The
step is a plain eager function of (params, carry, chunk) returning
(output, next carry), the counterpart of JAX's ``streaming_step_impl``;
the entry points run it as one captured device program per chunk over a
carry updated in place (``streaming/program.py``).

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
from realtime_yukarin_tpu_torch.dsp.resample import resample_chunk
from realtime_yukarin_tpu_torch.dsp.world import analyze_given_f0
from realtime_yukarin_tpu_torch.models.acoustic import convert_mc_streamed
from realtime_yukarin_tpu_torch.models.super_resolution import (
    refine_envelope)
from realtime_yukarin_tpu_torch.models.vocoders import vocoder
from realtime_yukarin_tpu_torch.models.voice_changer import (compute_dtype,
                                                             convert_f0_stats)
from realtime_yukarin_tpu_torch.ops.dft import device_const
from realtime_yukarin_tpu_torch.streaming.state import (StreamCarry,
                                                        StreamGeometry,
                                                        input_plan,
                                                        noise_bins,
                                                        output_plan)
from realtime_yukarin_tpu_torch.utils import profiling

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


def _threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words."""
    def rotl(v, d):
        return (v << np.uint32(d)) | (v >> np.uint32(32 - d))
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _key_bits(key: tuple[int, int]) -> np.ndarray:
    """``jax.random.bits(key, (3,), uint32)`` of a raw Threefry key (the
    partitionable bit stream: word i enciphers the counter pair (0, i))."""
    b0, b1 = _threefry2x32(key, np.zeros(3, np.uint32),
                           np.arange(3, dtype=np.uint32))
    return b0 ^ b1


def _check_seed(seed: int) -> None:
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")


def noise_key_from_seed(seed: int) -> tuple[int, int, int]:
    """A stream's noise permutation from an integer seed: the three words
    ``jax.random.bits(jax.random.key(seed), (3,), uint32)`` gives (the
    default Threefry key and its partitionable bit stream, computed here
    with NumPy), so a seed means the same noise in both packages.  The
    key of a seed in [0, 2**32) is (0, seed)."""
    _check_seed(seed)
    return noise_key_from_bits(_key_bits((0, seed)))


def lane_noise_keys(seed: int, num_streams: int
                    ) -> list[tuple[int, int, int]]:
    """The batched server's per-lane noise permutations: lane i reads the
    bits of ``jax.random.fold_in(jax.random.key(seed), i)``, the JAX
    package's lane keys.  ``fold_in(k, i)`` enciphers the counter pair
    (0, i) under k, and its two output words are the new key."""
    _check_seed(seed)
    y0, y1 = _threefry2x32((0, seed), np.zeros(num_streams, np.uint32),
                           np.arange(num_streams, dtype=np.uint32))
    return [noise_key_from_bits(_key_bits((int(a), int(b))))
            for a, b in zip(y0, y1)]


def frame_noise(noise_key, start_frame, count: int, bins: int,
                like: torch.Tensor) -> torch.Tensor:
    """Noise for global frames [start, start+count) -> [..., count, bins,
    2].

    ``noise_key`` is (offset, stride, shift) or an int64 tensor [..., 3]
    of them, ``start_frame`` an int or an int64 tensor [...] (one per
    stream).  Frame i's gaussians are table row (pos*stride + offset +
    block*shift) mod T with pos = i mod T and block = floor(i / T) mod T
    (floor semantics: the first frames of a stream are negative).  With a
    device key tensor and an int or device start nothing is copied from
    the host, so a graph can capture it."""
    T = NOISE_TABLE_FRAMES
    dev = like.device
    table = device_const(_noise_table_np, bins, like=like)
    key = torch.as_tensor(noise_key, dtype=torch.int64, device=dev)
    if isinstance(start_frame, int):
        gpos = torch.arange(start_frame, start_frame + count,
                            dtype=torch.int64, device=dev)
    else:
        start = torch.as_tensor(start_frame, dtype=torch.int64, device=dev)
        gpos = start[..., None] + torch.arange(count, dtype=torch.int64,
                                               device=dev)
    offset, stride, shift = (key[..., j, None] for j in range(3))
    pos = torch.remainder(gpos, T)
    block = torch.remainder(torch.div(gpos, T, rounding_mode="floor"), T)
    idx = torch.remainder(pos * stride + offset + block * shift, T)
    return table[idx]


def streaming_step(params: dict, carry: StreamCarry, chunk: torch.Tensor,
                   noise_key, cfg: Config, use_sr: bool = True,
                   vocoder_mode: str = "dsp"
                   ) -> tuple[torch.Tensor, StreamCarry]:
    """One chunk in, one chunk out (constant D-frame latency), for one
    stream or a batch of them.

    chunk: [..., chunk_in_samples] new input PCM at ``cfg.dsp.in_rate`` on
    the carry's device; the leading dims (none for one stream, [N] for N
    streams) are the carry's.  ``noise_key`` is (offset, stride, shift) or
    an int64 tensor [..., 3] (one per stream).  Returns converted PCM
    [..., chunk_out_samples] at ``cfg.dsp.out_rate`` and the next carry.
    Every stream's frames go through each kernel together: one launch per
    kernel per step, whatever N.  ``vocoder_mode`` (a key of
    ``models.vocoders.VOCODERS``) must be the one the carry was made for
    (:func:`init_stream`).  Each stage begins with its marker on the
    device (``utils/profiling.py``): ``resample_in``, ``analysis``,
    ``stage1``, ``sr`` (also without SR; not in a mode that reads no
    envelope, which decodes none and runs no SR), the mode's synthesis
    markers (``render``, or the generator's) and ``resample_out``.
    """
    voc = vocoder(vocoder_mode)
    use_sr = use_sr and voc.reads_envelope
    geo = StreamGeometry.from_config(cfg, use_sr, vocoder_mode=vocoder_mode)
    dsp = cfg.dsp
    hop = dsp.hop
    Fc = geo.chunk_frames
    mctx = geo.model_ctx
    like = carry.wave_buf

    # 0. resample the client chunk to the internal rate (a hop-aligned
    # delay, so the rest of the step is oblivious)
    profiling.mark("resample_in", like)
    chunk, rs_in = resample_chunk(carry.rs_in, chunk.to(carry.wave_buf),
                                  input_plan(dsp, geo.chunk_samples))

    # 1. roll the wave buffer and append the new chunk
    profiling.mark("analysis", like)
    buf = torch.cat([carry.wave_buf[..., geo.chunk_samples:], chunk],
                    dim=-1)

    # 2. analyse ONLY the newly final frames; raw F0 also for the E
    # trailing provisional frames, and the El raws before them come from
    # the carry
    C = geo.cache_frames
    E = geo.f0_edge
    El = geo.f0_left
    off = geo.buf_frame0_offset + C * hop
    raw_fresh, cand_fresh, cost_fresh = f0_raw_and_candidates(
        buf, geo.fresh_frames, dsp, off)
    raw_ext = torch.cat([carry.f0_raw_prev, raw_fresh], dim=-1)
    cand_ext = torch.cat([carry.f0_cand_prev, cand_fresh], dim=-2)
    cost_ext = torch.cat([carry.f0_cost_prev, cost_fresh], dim=-2)
    m_ext = median3(raw_ext)
    hl = dsp.f0_snap_left_eff
    hr = dsp.f0_snap_halo
    lo = El - hl                                  # m_ext index of frame C-hl
    win = slice(lo, lo + Fc + hl + hr)
    snapped, choice = viterbi_snap(m_ext[..., win], cand_ext[..., win, :],
                                   cost_ext[..., win, :], dsp)
    # ONE power spectrogram (one kernel launch) for voicing revision,
    # refinement, envelope and aperiodicity
    P = power_spectrogram(buf, Fc, dsp, off)
    f0_final = voicing_revision(buf, snapped[..., hl: hl + Fc],
                                choice[..., hl: hl + Fc], Fc, dsp, off, P=P)
    ffresh = analyze_given_f0(buf, f0_final, Fc, dsp, off, refine=True, P=P)

    f0_all = torch.cat([carry.f0_cache, ffresh.f0], dim=-1)   # [.., Fn - E]
    mc_all = torch.cat([carry.mc_cache, ffresh.mc], dim=-2)
    ap_all = torch.cat([carry.ap_cache, ffresh.ap], dim=-2)

    # 3. convert: stage 1 advances by the Fc newly final input frames via
    # its per-layer caches; its outputs (lagging c1 frames) extend the
    # carried stage-1 output cache to the range SR + synthesis need.  The
    # vocoder nets read ctx_v more frames on each side (their conv halo):
    # Lv rows from frame s.
    ctx_v = voc.context_frames(cfg)
    c1 = cfg.acoustic.context_frames
    dtype = compute_dtype(cfg)
    Fn = geo.analysis_frames
    L = Fc + 1
    Lv = L + 2 * ctx_v
    s = mctx - ctx_v                          # first frame synthesis reads
    profiling.mark("stage1", like)
    res, stage1_acts = convert_mc_streamed(
        params["stage1"], mc_all[..., Fn - E - Fc: Fn - E, :],
        f0_all[..., Fn - E - Fc: Fn - E], carry.stage1_acts, cfg.acoustic,
        dtype)
    mc_c_fresh = mc_all[..., Fn - E - c1 - Fc: Fn - E - c1, :] + res
    mc_c_need = torch.cat([carry.mc_c_cache, mc_c_fresh], dim=-2)
    f0c_need = convert_f0_stats(f0_all[..., c1 + E: Fn - c1 - E],
                                params["f0_stats"])
    # the needed arrays start at frame c1 + E, so frame s sits at SR's
    # halo (and the frames StreamGeometry adds for a net's rows)
    need = slice(s - c1 - E, s - c1 - E + Lv)
    f0v, mcv = f0c_need[..., need], mc_c_need[..., need, :]
    apv = ap_all[..., s: s + Lv, :]
    envv = None
    if voc.reads_envelope:
        env_low = decode_mcep(mc_c_need, dsp)
        profiling.mark("sr", like)
        env_mid = (refine_envelope(params["stage2"], env_low,
                                   cfg.super_resolution, dsp, dtype)
                   if use_sr else env_low)
        envv = env_mid[..., need, :]

    # 4. synthesize Fc frames: a renderer with position-deterministic
    # noise, or a net over its halo
    out, synth_carry = voc.stream(
        params, cfg, f0v, envv, apv, mcv, carry.synth,
        lambda: frame_noise(noise_key, carry.frame_pos, Fc, noise_bins(cfg),
                            like=buf), dtype, like)

    # 5. resample the converted chunk to the client output rate
    profiling.mark("resample_out", like)
    out, rs_out = resample_chunk(carry.rs_out, out,
                                 output_plan(dsp, geo.chunk_samples))

    new_carry = StreamCarry(
        wave_buf=buf, synth=synth_carry, frame_pos=carry.frame_pos + Fc,
        mc_c_cache=mc_c_need[..., Fc:, :], stage1_acts=stage1_acts,
        f0_cache=f0_all[..., Fc:], mc_cache=mc_all[..., Fc:, :],
        ap_cache=ap_all[..., Fc:, :],
        f0_raw_prev=raw_ext[..., Fc: Fc + El],
        f0_cand_prev=cand_ext[..., Fc: Fc + El, :],
        f0_cost_prev=cost_ext[..., Fc: Fc + El, :],
        rs_in=rs_in, rs_out=rs_out)
    return out, new_carry


def init_stream(params: dict, cfg: Config, use_sr: bool = True,
                vocoder_mode: str = "dsp", device=None
                ) -> tuple[StreamCarry, StreamGeometry]:
    """Initial carry (on ``device``, ``cuda`` by default) and geometry for
    ``vocoder_mode`` (a key of ``models.vocoders.VOCODERS``)."""
    device = resolve_device(device)
    geo = StreamGeometry.from_config(cfg, use_sr, vocoder_mode=vocoder_mode)
    return StreamCarry.init(cfg, geo, params, device, vocoder_mode), geo
