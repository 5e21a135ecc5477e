"""The vocoder modes: one record each holds all that differs between them,
so that no other module of the port names a mode.  A record's ``vocode(params,
cfg, f0, env, ap, mc, noise, synth, ctx, dtype, mark) -> (wave, synth)`` turns
F + 1 + 2·ctx rows of converted features into F·hop samples; ``noise()``
draws the frame noise (the modes that render call it) and ``mark(stage)``
marks a stage on the device."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from realtime_yukarin_tpu_torch.config import (Config, _check_mode,
                                               resolve_vocoder_mode)
from realtime_yukarin_tpu_torch.dsp.synthesis import (SynthCarry, WaveCarry,
                                                      render, synthesize)
from realtime_yukarin_tpu_torch.models.vocoder_bigvgan import (
    BigVGANGenerator)
from realtime_yukarin_tpu_torch.models.vocoder_hifigan import (
    HiFiGANGenerator, hifigan_vocode)
from realtime_yukarin_tpu_torch.models.vocoder_nn import (
    neural_vocoder_controls)
from realtime_yukarin_tpu_torch.models.vocoder_wave import waveform_vocode
from realtime_yukarin_tpu_torch.utils import profiling

HIFIGAN = "vocoder_hifigan"     # the params key of the HiFi-GAN generator
BIGVGAN = "vocoder_bigvgan"     # the params key of the BigVGAN generator


@dataclasses.dataclass(frozen=True)
class Vocoder:
    """One mode; the defaults are the DSP renderer's family."""
    context_frames: Callable    # cfg -> the net's halo in frames
    vocode: Callable            # the module docstring's
    # (params, cfg, x: N x (L + 2·ctx) rows in, L, dtype) -> {stage: (net,
    # *args) or None for 0}: the calls ``model_stage_flops`` counts
    learned_calls: Callable
    reads_envelope: bool = True  # False: no envelope decode and no SR
    # (cfg, device) -> the synth carry (None: the mode keeps none)
    init_synth: Callable = lambda cfg, device: SynthCarry.zeros(cfg.dsp,
                                                                device)
    net: tuple | None = None    # (params key, cfg -> module) of its own net
    splits: bool = True         # serves at model_parallel > 1
    # cfg -> the frames one row of its net's input spans: the streaming
    # geometry keeps a step's window and its halo to whole rows
    frames_per_row: Callable = lambda cfg: 1

    def stream(self, params, cfg, f0, env, ap, mc, synth, noise, dtype,
               like: torch.Tensor):
        """Step 4 of ``streaming_step``, marked on ``like``'s device."""
        return self.vocode(params, cfg, f0, env, ap, mc, noise, synth,
                           self.context_frames(cfg), dtype,
                           lambda stage: profiling.mark(stage, like))

    def offline(self, params, cfg, feat, noise, dtype) -> torch.Tensor:
        """An utterance's F + 1 rows (the last one repeated), unmarked."""
        return self.vocode(params, cfg, feat.f0, feat.env, feat.ap, feat.mc,
                           noise, None, 0, dtype, lambda stage: None)[0]


def _dsp(params, cfg, f0, env, ap, mc, noise, synth, ctx, dtype, mark):
    mark("render")
    return synthesize(f0, env, ap, noise(), cfg.dsp, synth)


def _ddsp(params, cfg, f0, env, ap, mc, noise, synth, ctx, dtype, mark):
    mark("render")
    noise = noise()
    amps, nmag, f0f, voiced = neural_vocoder_controls(
        params["vocoder"], f0, env, ap, mc, cfg.vocoder_nn, cfg.dsp, dtype)
    L = f0.shape[-1] - 2 * ctx
    rows = slice(ctx, ctx + L)
    return render(amps[..., rows, :], nmag[..., ctx: ctx + L - 1, :],
                  f0f[..., rows], voiced[..., rows], noise, cfg.dsp, synth)


def _wave(params, cfg, f0, env, ap, mc, noise, synth, ctx, dtype, mark):
    mark("render")
    return waveform_vocode(params["vocoder_wave"], f0, env, ap, mc, noise(),
                           cfg.vocoder_wave, cfg.dsp, synth, out_ctx=ctx,
                           dtype=dtype)


def _generator(key: str, section: str, make: type) -> Vocoder:
    """The record of a GAN generator mode (``models/vocoder_hifigan.py``'s
    skeleton; ``key`` its params key, ``section`` its config section): it
    reads mc, ap and F0, keeps no carry (each step reads its halo anew,
    every layer over the rows its kept samples depend on) and has no layer
    split over a model group; its halo is its receptive field in frames,
    whole conditioning rows."""
    def halo(cfg):
        return getattr(cfg, section).halo_frames(cfg.dsp.hop)

    def vocode(params, cfg, f0, env, ap, mc, noise, synth, ctx, dtype,
               mark):
        mark("vocoder")     # then one a stage, and again before conv_post
        return hifigan_vocode(params[key], f0, mc, ap, dtype, out_ctx=ctx,
                              mark=mark), synth
    return Vocoder(
        context_frames=halo, reads_envelope=False,
        init_synth=lambda cfg, device: None, vocode=vocode, splits=False,
        learned_calls=lambda params, cfg, x, L, dtype: {
            "vocoder": None, key: (params[key], x, dtype, None, halo(cfg))},
        net=(key, lambda cfg: make(getattr(cfg, section), cfg.dsp)),
        frames_per_row=lambda cfg: getattr(cfg, section).frames_per_row(
            cfg.dsp.hop))


def _wave_calls(params, cfg, x, L, dtype) -> dict[str, tuple]:
    z, n, b = x.new_zeros, x.shape[0], torch.bool
    return {"vocoder": (
        params["vocoder_wave"], x, z(n, L), z(n, L), z(n, L, dtype=b), z(n),
        z(n, dtype=b), z(n, cfg.vocoder_wave.phase_fractional),
        cfg.vocoder_wave.context_frames, L, dtype)}


VOCODERS: dict[str, Vocoder] = {
    "dsp": Vocoder(context_frames=lambda cfg: 0, vocode=_dsp,
                   learned_calls=lambda *args: {"vocoder": None}),
    "ddsp": Vocoder(
        context_frames=lambda cfg: cfg.vocoder_nn.context_frames,
        vocode=_ddsp,
        learned_calls=lambda params, cfg, x, L, dtype: {
            "vocoder": (params["vocoder"], x, dtype)}),
    "wave": Vocoder(
        context_frames=lambda cfg: cfg.vocoder_wave.context_frames,
        vocode=_wave, learned_calls=_wave_calls,
        init_synth=lambda cfg, device: WaveCarry.zeros(
            cfg.dsp, device, phase_fractional=cfg.vocoder_wave
            .phase_fractional)),
    "hifigan": _generator(HIFIGAN, "vocoder_hifigan", HiFiGANGenerator),
    "bigvgan": _generator(BIGVGAN, "vocoder_bigvgan", BigVGANGenerator),
}
EXTRA_NETS = tuple(v.net[0] for v in VOCODERS.values() if v.net)


def vocoder(mode: str) -> Vocoder:
    """The record of ``mode``; ValueError for a name that is none."""
    return VOCODERS[_check_mode(mode)]


def mode_from_flags(choice: str | None, neural_vocoder: bool,
                    cfg: Config) -> str:
    """The mode the CLIs' flags select: ``--vocoder`` (``choice``) wins,
    then the legacy ``--neural_vocoder`` (ddsp), then the config's mode;
    ValueError for a name that is no mode."""
    if choice is None and not neural_vocoder:
        return cfg.resolved_vocoder_mode
    return resolve_vocoder_mode(neural_vocoder, choice)
