"""Offline conversion of a whole utterance (PyTorch port of
``pipeline.py``): analysis -> both model stages and the F0 transform ->
synthesis, in one pass over all F frames.

The analysis sends all F frames to the power spectrum and the envelope
cepstrum in one launch each, and the render all F frames to the harmonic
bank.  The noise is read from the same position-deterministic table as
the streaming step from frame 0, so the streamed output equals this one
on the interior.  Entry points run on ``device`` (``cuda`` unless the
caller names another; no fallback) with the params already there
(``models.voice_changer.params_to``), under ``torch.no_grad``.
"""

from __future__ import annotations

import torch

from realtime_yukarin_tpu_torch.config import Config, resolve_vocoder_mode
from realtime_yukarin_tpu_torch.dsp.resample import resample_signal
from realtime_yukarin_tpu_torch.dsp.synthesis import synthesize
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature, analyze
from realtime_yukarin_tpu_torch.models.vocoder_nn import neural_vocode
from realtime_yukarin_tpu_torch.models.vocoder_wave import waveform_vocode
from realtime_yukarin_tpu_torch.models.voice_changer import (compute_dtype,
                                                             convert_features)
from realtime_yukarin_tpu_torch.streaming.pipeline import (frame_noise,
                                                           resolve_device)
from realtime_yukarin_tpu_torch.streaming.state import (StreamGeometry,
                                                        input_plan,
                                                        noise_bins,
                                                        output_plan)


def _extend_one_frame(feat: AcousticFeature) -> AcousticFeature:
    """Repeat the last frame: offline stand-in for the streaming layer's
    one-frame synthesis lookahead."""
    return AcousticFeature(
        f0=torch.cat([feat.f0, feat.f0[-1:]]),
        env=torch.cat([feat.env, feat.env[-1:]]),
        ap=torch.cat([feat.ap, feat.ap[-1:]]),
        mc=torch.cat([feat.mc, feat.mc[-1:]]))


def _on(wave, device) -> torch.Tensor:
    """``wave`` (NumPy or torch) as a float32 tensor on ``device``."""
    return torch.as_tensor(wave, dtype=torch.float32).to(device)


def _check_params(params: dict, device: torch.device) -> None:
    where = params["f0_stats"]["src_mean"].device
    if where.type != device.type:
        raise ValueError(f"params are on {where}, the conversion runs on "
                         f"{device}: move them with "
                         f"models.voice_changer.params_to(params, device)")


@torch.no_grad()
def offline_convert(params: dict, wave, noise_key: tuple[int, int, int],
                    cfg: Config, num_frames: int, use_sr: bool = True,
                    use_neural_vocoder: bool = False,
                    vocoder_mode: str | None = None, device=None
                    ) -> torch.Tensor:
    """wave [T] at the internal rate -> converted wave [num_frames * hop]
    on ``device``."""
    device = resolve_device(device)
    _check_params(params, device)
    mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)
    dtype = compute_dtype(cfg)
    feat = analyze(_on(wave, device), num_frames, cfg.dsp)
    conv = _extend_one_frame(convert_features(params, feat, cfg,
                                              use_sr=use_sr))
    noise = frame_noise(noise_key, 0, num_frames, noise_bins(cfg),
                        like=conv.env)
    if mode == "ddsp":
        out, _ = neural_vocode(params["vocoder"], conv.f0, conv.env, conv.ap,
                               conv.mc, noise, cfg.vocoder_nn, cfg.dsp,
                               dtype=dtype)
    elif mode == "wave":
        out, _ = waveform_vocode(params["vocoder_wave"], conv.f0, conv.env,
                                 conv.ap, conv.mc, noise, cfg.vocoder_wave,
                                 cfg.dsp, dtype=dtype)
    else:
        out, _ = synthesize(conv.f0, conv.env, conv.ap, noise, cfg.dsp)
    return out


@torch.no_grad()
def offline_convert_io(params: dict, wave_in, noise_key: tuple[int, int, int],
                       cfg: Config, use_sr: bool = True,
                       use_neural_vocoder: bool = False,
                       vocoder_mode: str | None = None, device=None
                       ) -> torch.Tensor:
    """Client-rate offline conversion: wave at ``cfg.dsp.in_rate`` ->
    converted wave at ``cfg.dsp.out_rate``, through the resample plans the
    streaming step uses (so streamed == offline holds across rates).
    Identity plans make this exactly :func:`offline_convert`."""
    device = resolve_device(device)
    mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)
    geo = StreamGeometry.from_config(cfg, use_sr, vocoder_mode=mode)
    x = resample_signal(_on(wave_in, device),
                        input_plan(cfg.dsp, geo.chunk_samples))
    hop = cfg.dsp.hop
    F = x.shape[0] // hop
    y = offline_convert(params, x[: F * hop], noise_key, cfg, F, use_sr,
                        vocoder_mode=mode, device=device)
    return resample_signal(y, output_plan(cfg.dsp, geo.chunk_samples))


@torch.no_grad()
def offline_analyze(wave, cfg: Config, num_frames: int, device=None
                    ) -> AcousticFeature:
    """wave [T] -> the AcousticFeature of ``num_frames`` frames."""
    return analyze(_on(wave, resolve_device(device)), num_frames, cfg.dsp)


@torch.no_grad()
def offline_synthesize(feat: AcousticFeature,
                       noise_key: tuple[int, int, int], cfg: Config
                       ) -> torch.Tensor:
    """DSP render of ``feat`` (F frames, on its own device) ->
    [F * hop]."""
    ext = _extend_one_frame(feat)
    noise = frame_noise(noise_key, 0, feat.f0.shape[0], noise_bins(cfg),
                        like=ext.env)
    out, _ = synthesize(ext.f0, ext.env, ext.ap, noise, cfg.dsp)
    return out
