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

:func:`offline_convert` is the counterpart of the JAX package's
conversion jitted per static ``num_frames``
(``realtime_yukarin_tpu/pipeline.py:44``, ``:72``), with the capture put
off until a length repeats: the first call at a length runs
:func:`offline_convert_eager` and remembers the length, the second warms
up and captures it as one device program (``streaming/program.py``), and
every later call copies the wave and the noise key into the program's
static buffers and replays.  A conversion made once (``cli.convert``)
thus pays nothing for a capture.  Lengths are kept by what JAX makes
static, the least recently used dropped beyond ``PROGRAM_CACHE_SIZE``
(JAX's cache is unbounded; a graph's pool per length is device memory).
:func:`offline_analyze` and :func:`offline_synthesize`, the counterparts
of ``realtime_yukarin_tpu/pipeline.py:97`` and ``:103``, are programs per
length the same way, in the same cache.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from realtime_yukarin_tpu_torch.config import (Config, resolve_vocoder_mode,
                                               runs_sr)
from realtime_yukarin_tpu_torch.dsp.resample import resample_signal
from realtime_yukarin_tpu_torch.dsp.synthesis import synthesize
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature, analyze
from realtime_yukarin_tpu_torch.models.vocoder_hifigan import hifigan_vocode
from realtime_yukarin_tpu_torch.models.vocoder_nn import neural_vocode
from realtime_yukarin_tpu_torch.models.vocoder_wave import waveform_vocode
from realtime_yukarin_tpu_torch.models.acoustic import convert_mc
from realtime_yukarin_tpu_torch.models.voice_changer import (
    compute_dtype, convert_f0_stats, convert_features)
from realtime_yukarin_tpu_torch.streaming.pipeline import (frame_noise,
                                                           resolve_device)
from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram
from realtime_yukarin_tpu_torch.streaming.state import (StreamGeometry,
                                                        input_plan,
                                                        noise_bins,
                                                        output_plan,
                                                        tree_copy_, tree_map)


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


PROGRAM_CACHE_SIZE = 8


class _Program(NamedTuple):
    program: CapturedProgram
    inputs: object               # static input: the wave (the features,
    #                              for a synthesis)
    key: torch.Tensor | None     # static input: the noise key, int64 [3]
    leaves: tuple                # the params' tensors, kept alive: the
    #                              graph holds their addresses


# signature -> its _Program, or None for a length seen once (run eagerly)
_programs: collections.OrderedDict = collections.OrderedDict()


def _program_for(sig: tuple, build, device: torch.device):
    """The entry cached under ``sig``: None the first time ``sig`` is seen
    (the caller runs eagerly), ``build()`` the second time, the cached
    entry after; the least recently used signature goes beyond
    ``PROGRAM_CACHE_SIZE``."""
    seen = sig in _programs
    entry = _programs.pop(sig, None)
    if seen and entry is None:
        entry = build()
    _programs[sig] = entry
    if len(_programs) > PROGRAM_CACHE_SIZE:
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # no replay of it in flight
        _programs.popitem(last=False)
    return entry


def _tensors(tree) -> list:
    """The tensors of a params tree (dicts, lists and tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for item in tree for t in _tensors(item)]


def cached_programs() -> list[CapturedProgram]:
    """The captured offline programs, least recently used first."""
    return [entry.program for entry in _programs.values() if entry]


def offline_convert(params: dict, wave, noise_key: tuple[int, int, int],
                    cfg: Config, num_frames: int, use_sr: bool = True,
                    use_neural_vocoder: bool = False,
                    vocoder_mode: str | None = None, device=None
                    ) -> torch.Tensor:
    """wave [T] at the internal rate -> converted wave [num_frames * hop]
    on ``device``, the caller's own tensor: :func:`offline_convert_eager`,
    run eagerly the first time (T, num_frames, use_sr, the mode, cfg, the
    device and the params' tensors) is seen and through the program
    captured for it from the second time on."""
    device = resolve_device(device)
    _check_params(params, device)
    mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)
    use_sr = runs_sr(use_sr, mode)
    wave = _on(wave, device)
    leaves = tuple(_tensors(params))
    sig = (tuple(wave.shape), num_frames, use_sr, mode, cfg, str(device),
           tuple(t.data_ptr() for t in leaves))

    def build():
        buf = wave.clone()
        key = torch.tensor(noise_key, dtype=torch.int64, device=device)
        return _Program(CapturedProgram(
            lambda: offline_convert_eager(params, buf, key, cfg, num_frames,
                                          use_sr, vocoder_mode=mode,
                                          device=device),
            device=device, name=f"offline {num_frames} frames ({mode})"),
            buf, key, leaves)

    entry = _program_for(sig, build, device)
    if entry is None:
        return offline_convert_eager(params, wave, noise_key, cfg,
                                     num_frames, use_sr, vocoder_mode=mode,
                                     device=device)
    entry.inputs.copy_(wave)
    entry.key.copy_(torch.as_tensor(noise_key, dtype=torch.int64))
    return entry.program()


@torch.no_grad()
def offline_convert_eager(params: dict, wave,
                          noise_key: tuple[int, int, int] | torch.Tensor,
                          cfg: Config, num_frames: int, use_sr: bool = True,
                          use_neural_vocoder: bool = False,
                          vocoder_mode: str | None = None, device=None
                          ) -> torch.Tensor:
    """:func:`offline_convert`'s body, run eagerly: the reference its
    replays are held to.  ``noise_key`` is (offset, stride, shift) or an
    int64 tensor [3] on ``device``."""
    device = resolve_device(device)
    _check_params(params, device)
    mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)
    dtype = compute_dtype(cfg)
    feat = analyze(_on(wave, device), num_frames, cfg.dsp)
    if mode == "hifigan":
        # the generator reads mc, ap and F0: no envelope, no SR
        f0c, mc_c, ap = (torch.cat([x, x[-1:]]) for x in (
            convert_f0_stats(feat.f0, params["f0_stats"]),
            convert_mc(params["stage1"], feat.mc, feat.f0, cfg.acoustic,
                       dtype), feat.ap))
        return hifigan_vocode(params["vocoder_hifigan"], f0c, mc_c, ap,
                              dtype)
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
    Identity plans make this exactly :func:`offline_convert`, which
    converts between the two eager resample edges."""
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


def offline_analyze(wave, cfg: Config, num_frames: int, device=None
                    ) -> AcousticFeature:
    """wave [T] -> the AcousticFeature of ``num_frames`` frames (the
    caller's tensors): :func:`offline_analyze_eager`, run eagerly the
    first time (T, num_frames, cfg.dsp, the device) is seen and through
    the program captured for it from the second time on."""
    device = resolve_device(device)
    wave = _on(wave, device)
    sig = ("analyze", tuple(wave.shape), num_frames, cfg.dsp, str(device))

    def build():
        buf = wave.clone()
        return _Program(CapturedProgram(
            lambda: offline_analyze_eager(buf, cfg, num_frames, device),
            device=device, name=f"analysis {num_frames} frames"),
            buf, None, ())

    entry = _program_for(sig, build, device)
    if entry is None:
        return offline_analyze_eager(wave, cfg, num_frames, device)
    entry.inputs.copy_(wave)
    return entry.program()


@torch.no_grad()
def offline_analyze_eager(wave, cfg: Config, num_frames: int, device=None
                          ) -> AcousticFeature:
    """:func:`offline_analyze`'s body, run eagerly: the reference its
    replays are held to."""
    return analyze(_on(wave, resolve_device(device)), num_frames, cfg.dsp)


def offline_synthesize(feat: AcousticFeature,
                       noise_key: tuple[int, int, int], cfg: Config
                       ) -> torch.Tensor:
    """DSP render of ``feat`` (F frames, on its own device) -> [F * hop],
    the caller's tensor: :func:`offline_synthesize_eager`, run eagerly the
    first time (F, cfg.dsp, the device) is seen and through the program
    captured for it from the second time on."""
    device = feat.f0.device
    sig = ("synthesize", tuple(feat.f0.shape), cfg.dsp, str(device))

    def build():
        static = tree_map(torch.clone, feat)
        key = torch.tensor(noise_key, dtype=torch.int64, device=device)
        return _Program(CapturedProgram(
            lambda: offline_synthesize_eager(static, key, cfg),
            device=device,
            name=f"synthesis {feat.f0.shape[0]} frames"), static, key, ())

    entry = _program_for(sig, build, device)
    if entry is None:
        return offline_synthesize_eager(feat, noise_key, cfg)
    tree_copy_(entry.inputs, feat)
    entry.key.copy_(torch.as_tensor(noise_key, dtype=torch.int64))
    return entry.program()


@torch.no_grad()
def offline_synthesize_eager(feat: AcousticFeature,
                             noise_key: tuple[int, int, int] | torch.Tensor,
                             cfg: Config) -> torch.Tensor:
    """:func:`offline_synthesize`'s body, run eagerly: the reference its
    replays are held to.  ``noise_key`` is (offset, stride, shift) or an
    int64 tensor [3] on the features' device."""
    ext = _extend_one_frame(feat)
    noise = frame_noise(noise_key, 0, feat.f0.shape[0], noise_bins(cfg),
                        like=ext.env)
    out, _ = synthesize(ext.f0, ext.env, ext.ap, noise, cfg.dsp)
    return out
