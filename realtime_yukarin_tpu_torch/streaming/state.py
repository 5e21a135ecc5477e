"""Streaming state and geometry (PyTorch port of ``streaming/state.py``).

One rolling wave buffer, the synthesizer carry, a frame counter and the
per-frame feature caches, with every halo turned into static shape
arithmetic derived from the Config:

  Fc     chunk frames                 (0.1 s -> 20 frames)
  mctx   model halo frames            (stage1 + stage2 + F0 edge frames)
  AH     analysis half-window samples (max of fft, f0 and voicing windows)
  D      output delay in frames:      mctx + ceil(AH / hop)
  Fn     analysis frames per step:    Fc + 2*mctx + 1
  L_buf  wave buffer samples:         (Fc + 2*mctx + ah)*hop + AH

(mctx also holds the vocoder net's halo, ``models/vocoders.py``; in the
hifigan mode the generator's 21 frames take SR's 4: D is 42 frames, 85 ms
more than the dsp mode's 25.  A net whose input rows span r frames, the
bigvgan mode's pairs, keeps its window on whole rows of the global frame
grid: the chunk must be whole rows, and mctx takes the frames that make D
a multiple of r, so each step's window starts on a row: in the bigvgan
mode the generator's 68 frames and one, D 90 frames.)
Step k consumes input chunk k and emits output frames [k*Fc - D,
(k+1)*Fc - D).  Client rates other than the internal one go through the
polyphase resamplers of :func:`input_plan` / :func:`output_plan` at both
edges of the step.
"""

from __future__ import annotations

import dataclasses

import torch

from realtime_yukarin_tpu_torch.config import Config, DspConfig
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.dsp import resample
from realtime_yukarin_tpu_torch.dsp.f0 import _BIG as _VITERBI_BIG
from realtime_yukarin_tpu_torch.dsp.synthesis import SynthCarry, WaveCarry
from realtime_yukarin_tpu_torch.models.vocoders import vocoder


def input_plan(dsp: DspConfig, chunk_samples: int) -> resample.ResamplePlan:
    """Client-rate -> internal-rate plan for one streaming chunk.  The
    delay is hop-aligned so the resampled stream sits on the analysis
    frame grid (streamed == offline stays exact)."""
    if dsp.in_rate == dsp.sample_rate:
        return resample.make_plan(dsp.sample_rate, dsp.sample_rate,
                                  chunk_samples)
    ci = chunk_samples * dsp.in_rate
    if ci % dsp.sample_rate:
        raise ValueError(
            f"chunk of {chunk_samples} samples @{dsp.sample_rate} is not a "
            f"whole number of samples @{dsp.in_rate}; pick chunk_ms "
            f"divisible by both rates")
    return resample.make_plan(dsp.in_rate, dsp.sample_rate,
                              ci // dsp.sample_rate,
                              align_delay_to=dsp.hop)


def output_plan(dsp: DspConfig, chunk_samples: int) -> resample.ResamplePlan:
    """Internal-rate -> client-rate plan for one streaming chunk."""
    return resample.make_plan(dsp.sample_rate, dsp.out_rate, chunk_samples)


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    chunk_frames: int
    chunk_samples: int       # internal-rate samples per chunk
    chunk_in_samples: int    # client-rate samples consumed per chunk
    chunk_out_samples: int   # client-rate samples emitted per chunk
    model_ctx: int
    analysis_half: int
    delay_frames: int
    analysis_frames: int
    buf_samples: int
    buf_frame0_offset: int   # sample offset of analysis frame 0's center
    in_delay: int            # input-resampler delay (internal samples)
    out_delay: int           # output-resampler delay (output-rate samples)
    stage1_ctx: int          # stage-1 one-sided receptive field (frames)
    f0_edge: int             # trailing provisional-F0 frames (median+snap)
    f0_left: int             # leading raw/candidate cache frames

    @classmethod
    def from_config(cls, cfg: Config, use_sr: bool = True,
                    vocoder_mode: str = "dsp") -> "StreamGeometry":
        """Geometry of one streaming configuration; the vocoder mode comes
        from the argument, as in the JAX package, not from
        ``cfg.vocoder_mode``."""
        voc = vocoder(vocoder_mode)
        dsp = cfg.dsp
        hop = dsp.hop
        Fc = cfg.streaming.chunk_frames(dsp)
        E = dsp.f0_edge_frames
        mctx = cfg.acoustic.context_frames + E + voc.context_frames(cfg)
        if use_sr and voc.reads_envelope:
            mctx += cfg.super_resolution.context_frames
        AH = max(dsp.fft_size // 2, (dsp.f0_frame_len + 1) // 2,
                 (dsp.voicing_energy_win + 1) // 2)
        ah_frames = -(-AH // hop)
        r = voc.frames_per_row(cfg)
        if Fc % r:
            raise ValueError(f"a chunk of {Fc} frames is no whole number of "
                             f"the vocoder's rows of {r} frames")
        mctx += -(mctx + ah_frames) % r       # D on a row's first frame
        D = mctx + ah_frames
        p_in = input_plan(dsp, Fc * hop)
        p_out = output_plan(dsp, Fc * hop)
        return cls(chunk_frames=Fc, chunk_samples=Fc * hop,
                   chunk_in_samples=p_in.chunk_in,
                   chunk_out_samples=p_out.chunk_out,
                   model_ctx=mctx, analysis_half=AH, delay_frames=D,
                   analysis_frames=Fc + 2 * mctx + 1,
                   buf_samples=(Fc + 2 * mctx + ah_frames) * hop + AH,
                   buf_frame0_offset=AH, in_delay=p_in.delay_out,
                   out_delay=p_out.delay_out,
                   stage1_ctx=cfg.acoustic.context_frames,
                   f0_edge=E, f0_left=dsp.f0_left_frames)

    def latency_samples(self, hop: int) -> int:
        """Algorithmic latency in internal-rate samples (pipeline + the
        frame-aligned input-resampler delay)."""
        return self.delay_frames * hop + self.in_delay

    def latency_out_samples(self, dsp: DspConfig) -> int:
        """End-to-end latency in output-rate samples."""
        return (self.latency_samples(dsp.hop) * dsp.out_rate
                // dsp.sample_rate + self.out_delay)

    @property
    def cache_frames(self) -> int:
        """Leading analysis frames reused from the previous step."""
        return self.analysis_frames - self.chunk_frames - self.f0_edge

    @property
    def stage1_cache_frames(self) -> int:
        """Stage-1 output frames carried across steps."""
        return 2 * (self.model_ctx - self.stage1_ctx - self.f0_edge) + 1

    @property
    def fresh_frames(self) -> int:
        """Frames whose raw F0 is estimated per step: Fc + E."""
        return self.chunk_frames + self.f0_edge


@dataclasses.dataclass
class StreamCarry:
    """Streaming state on the device.

    One stream's carry has the shapes below; a carry of N streams (the
    batched server's) has a leading [N] on every leaf, ``frame_pos``
    included, since lanes that pause or reset part ways.  The feature
    caches hold the leading ``cache_frames`` analysis frames of the next
    step's window: analysis is frame-local, so a frame analysed when its
    window was complete never changes."""

    wave_buf: torch.Tensor      # [buf_samples] rolling input window
    synth: SynthCarry | WaveCarry | None  # the mode's ``init_synth``
    frame_pos: torch.Tensor     # [] int64 global index of the next output
    #                             frame
    f0_cache: torch.Tensor      # [C] final (snapped+refined) F0 per frame
    mc_cache: torch.Tensor      # [C, M+1] mel-cepstra of cached frames
    ap_cache: torch.Tensor      # [C, B] band aperiodicity of cached frames
    f0_raw_prev: torch.Tensor   # [El] raw F0 of the El frames before fresh
    f0_cand_prev: torch.Tensor  # [El, K] top-K dip candidates before fresh
    f0_cost_prev: torch.Tensor  # [El, K] their Viterbi emission costs
    mc_c_cache: torch.Tensor    # [Cs, M+1] stage-1 outputs carried over
    stage1_acts: tuple          # per-block [k-1, hidden] activation tails
    rs_in: torch.Tensor | None = None   # input-resampler history (client
    #                                     rate; None at identity rates)
    rs_out: torch.Tensor | None = None  # output-resampler history (internal)

    @classmethod
    def init(cls, cfg: Config, geo: StreamGeometry, params: dict, device,
             vocoder_mode: str = "dsp") -> "StreamCarry":
        """The state after an infinite history of silence: the caches are
        the analysis (and stage-1 conversion) of the initial zero
        buffer."""
        from realtime_yukarin_tpu_torch.dsp.world import analyze
        from realtime_yukarin_tpu_torch.models.acoustic import (
            stage1_cache_init)
        from realtime_yukarin_tpu_torch.models.voice_changer import (
            compute_dtype)
        dt = torch.float32
        zeros = torch.zeros((geo.buf_samples,), dtype=dt, device=device)
        sil = analyze(zeros, geo.cache_frames, cfg.dsp,
                      center_offset=geo.buf_frame0_offset)
        acts, res_row = stage1_cache_init(
            params["stage1"], sil.mc[0], sil.f0[0], cfg.acoustic,
            compute_dtype(cfg))
        mc_c_row = sil.mc[0] + res_row
        K = cfg.dsp.f0_cand_k
        return cls(
            wave_buf=zeros,
            synth=vocoder(vocoder_mode).init_synth(cfg, device),
            frame_pos=torch.tensor(-geo.delay_frames, dtype=torch.int64,
                                   device=device),
            f0_cache=sil.f0, mc_cache=sil.mc, ap_cache=sil.ap,
            f0_raw_prev=torch.zeros((geo.f0_left,), dtype=dt, device=device),
            # zero candidates = inactive frames for the window Viterbi —
            # exactly what analysis of the initial silence produces
            f0_cand_prev=torch.zeros((geo.f0_left, K), dtype=dt,
                                     device=device),
            f0_cost_prev=torch.full((geo.f0_left, K), _VITERBI_BIG,
                                    dtype=dt, device=device),
            mc_c_cache=mc_c_row[None].repeat(geo.stage1_cache_frames, 1),
            stage1_acts=acts,
            rs_in=resample.init_carry(
                input_plan(cfg.dsp, geo.chunk_samples), device),
            rs_out=resample.init_carry(
                output_plan(cfg.dsp, geo.chunk_samples), device))


def noise_bins(cfg: Config) -> int:
    return prim.noise_fft_size(cfg.dsp.hop) // 2 + 1


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a carry (a :class:`StreamCarry`, its
    synthesizer carries and tuples of them) or of a program's inputs and
    outputs (dataclasses, tuples and dicts of tensors), leaf by leaf across
    ``tree`` and ``rest``; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return type(tree)(**{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree)})


def tree_leaves(tree) -> list:
    """The tensors of a carry in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_copy_(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, leaf by leaf and in place:
    the donated carry's update (a captured graph holds ``dst``'s
    addresses).  ``src`` is fresh memory or ``dst`` itself, never a view
    that partly overlaps a ``dst`` leaf (``copy_`` refuses that)."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def snapshot(tree):
    """A copy of every tensor of a carry, for :func:`tree_copy_` to put
    back."""
    return tree_map(torch.clone, tree)
