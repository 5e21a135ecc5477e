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

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp.resample import resample_signal
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature, analyze
from realtime_yukarin_tpu_torch.models.vocoders import vocoder
from realtime_yukarin_tpu_torch.models.voice_changer import (
    compute_dtype, convert_features)
from realtime_yukarin_tpu_torch.streaming.pipeline import (frame_noise,
                                                           resolve_device)
from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram
from realtime_yukarin_tpu_torch.streaming.state import (
    input_plan, noise_bins, output_plan, tree_copy_, tree_map)


def extend_one_frame(feat: AcousticFeature) -> AcousticFeature:
    """Repeat the last frame: offline stand-in for the streaming layer's
    one-frame synthesis lookahead."""
    return tree_map(lambda a: torch.cat([a, a[-1:]]), feat)


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
                    vocoder_mode: str = "dsp", device=None
                    ) -> torch.Tensor:
    """wave [T] at the internal rate -> converted wave [num_frames * hop]
    on ``device``, the caller's own tensor: :func:`offline_convert_eager`,
    run eagerly the first time (T, num_frames, use_sr, the mode, cfg, the
    device and the params' tensors) is seen and through the program
    captured for it from the second time on."""
    device = resolve_device(device)
    _check_params(params, device)
    use_sr = use_sr and vocoder(vocoder_mode).reads_envelope
    wave = _on(wave, device)
    leaves = tuple(_tensors(params))
    sig = (tuple(wave.shape), num_frames, use_sr, vocoder_mode, cfg,
           str(device), tuple(t.data_ptr() for t in leaves))

    def build():
        buf = wave.clone()
        key = torch.tensor(noise_key, dtype=torch.int64, device=device)
        return _Program(CapturedProgram(
            lambda: offline_convert_eager(
                params, buf, key, cfg, num_frames, use_sr,
                vocoder_mode=vocoder_mode, device=device),
            device=device,
            name=f"offline {num_frames} frames ({vocoder_mode})"),
            buf, key, leaves)

    entry = _program_for(sig, build, device)
    if entry is None:
        return offline_convert_eager(params, wave, noise_key, cfg,
                                     num_frames, use_sr,
                                     vocoder_mode=vocoder_mode, device=device)
    entry.inputs.copy_(wave)
    entry.key.copy_(torch.as_tensor(noise_key, dtype=torch.int64))
    return entry.program()


@torch.no_grad()
def offline_convert_eager(params: dict, wave,
                          noise_key: tuple[int, int, int] | torch.Tensor,
                          cfg: Config, num_frames: int, use_sr: bool = True,
                          vocoder_mode: str = "dsp", device=None
                          ) -> torch.Tensor:
    """:func:`offline_convert`'s body, run eagerly: the reference its
    replays are held to.  ``noise_key`` is (offset, stride, shift) or an
    int64 tensor [3] on ``device``."""
    device = resolve_device(device)
    _check_params(params, device)
    voc = vocoder(vocoder_mode)
    dtype = compute_dtype(cfg)
    feat = analyze(_on(wave, device), num_frames, cfg.dsp)
    conv = extend_one_frame(convert_features(
        params, feat, cfg, use_sr, dtype, envelope=voc.reads_envelope))
    return voc.offline(
        params, cfg, conv,
        lambda: frame_noise(noise_key, 0, num_frames, noise_bins(cfg),
                            like=conv.env), dtype)


@torch.no_grad()
def offline_convert_io(params: dict, wave_in, noise_key: tuple[int, int, int],
                       cfg: Config, use_sr: bool = True,
                       vocoder_mode: str = "dsp", device=None
                       ) -> torch.Tensor:
    """Client-rate offline conversion: wave at ``cfg.dsp.in_rate`` ->
    converted wave at ``cfg.dsp.out_rate``, through the resample plans the
    streaming step uses (so streamed == offline holds across rates).
    Identity plans make this exactly :func:`offline_convert`, which
    converts between the two eager resample edges."""
    device = resolve_device(device)
    S = cfg.streaming.chunk_samples(cfg.dsp)
    x = resample_signal(_on(wave_in, device), input_plan(cfg.dsp, S))
    hop = cfg.dsp.hop
    F = x.shape[0] // hop
    y = offline_convert(params, x[: F * hop], noise_key, cfg, F, use_sr,
                        vocoder_mode=vocoder_mode, device=device)
    return resample_signal(y, output_plan(cfg.dsp, S))


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
    ext = extend_one_frame(feat)
    # the dsp mode's synthesis reads no params and runs no model
    return vocoder("dsp").offline(None, cfg, ext, lambda: frame_noise(
        noise_key, 0, feat.f0.shape[0], noise_bins(cfg), like=ext.env), None)
