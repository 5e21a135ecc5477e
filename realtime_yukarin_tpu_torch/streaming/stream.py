"""Host-facing streaming voice changer (PyTorch port of
``streaming/stream.py``): one object owns the carry on the device and runs
:func:`streaming_step` (its one-stream case: no leading dim) as one
captured program per chunk over that carry, updated in place
(``streaming/program.py``); a :class:`SegmentBuffer` re-chunks
arbitrary-size audio callbacks onto the static chunk grid."""

from __future__ import annotations

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.voice_changer import params_to
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    init_stream, noise_key_from_seed, resolve_device, streaming_step)
from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram
from realtime_yukarin_tpu_torch.streaming.segment import SegmentBuffer
from realtime_yukarin_tpu_torch.streaming.state import tree_copy_
from realtime_yukarin_tpu_torch.utils import profiling


class VoiceChangerStream:
    """Push PCM in with ``add``; pull converted PCM with ``process``.

    Runs on ``device`` (``cuda`` unless the caller passes another, e.g.
    ``"cpu"``; no fallback).  Input is PCM at ``cfg.dsp.in_rate``, output
    at ``cfg.dsp.out_rate``, delayed by ``latency_samples``; call
    ``flush()`` at the end of input to drain the tail.  The synthesis
    stage is ``vocoder_mode`` (a key of ``models.vocoders.VOCODERS``).
    The noise permutation comes from ``seed`` (the same noise as the JAX
    package's ``jax.random.key(seed)``) unless an explicit ``noise_key``
    (offset, stride, shift) is given.  On CUDA the constructor captures the
    step (``program``); each chunk is then one graph replay.
    """

    def __init__(self, params: dict, cfg: Config, use_sr: bool = True,
                 seed: int = 0, noise_key: tuple[int, int, int] | None = None,
                 vocoder_mode: str = "dsp", device=None):
        self.device = resolve_device(device)
        self._params = params_to(params, self.device)
        self._cfg = cfg
        self._use_sr = use_sr
        self._mode = vocoder_mode
        self._noise_key = torch.tensor(
            noise_key if noise_key is not None else noise_key_from_seed(seed),
            dtype=torch.int64, device=self.device)
        self._carry, self._geo = init_stream(self._params, cfg, use_sr,
                                             vocoder_mode=self._mode,
                                             device=self.device)
        self._chunk = torch.zeros(self._geo.chunk_in_samples,
                                  device=self.device)
        self.program = CapturedProgram(
            self._step, self._carry, self.device,
            name=f"stream step ({self._mode})")
        self._in = SegmentBuffer()
        self._in_pos = 0          # next input sample to consume
        self._written = 0         # total input samples added

    @property
    def chunk_samples(self) -> int:
        """Input chunk size (samples at cfg.dsp.in_rate)."""
        return self._geo.chunk_in_samples

    @property
    def chunk_out_samples(self) -> int:
        """Output chunk size (samples at cfg.dsp.out_rate)."""
        return self._geo.chunk_out_samples

    @property
    def latency_samples(self) -> int:
        """End-to-end delay in output-rate samples."""
        return self._geo.latency_out_samples(self._cfg.dsp)

    def _step(self) -> torch.Tensor:
        # the batched step's stage markers; one stream has no masks, so
        # carry_in is empty and carry_out holds the carry's store
        profiling.mark("carry_in", self._chunk)
        y, carry = streaming_step(self._params, self._carry, self._chunk,
                                  self._noise_key, self._cfg, self._use_sr,
                                  vocoder_mode=self._mode)
        profiling.mark("carry_out", self._chunk)
        tree_copy_(self._carry, carry)
        profiling.mark("end", self._chunk)
        return y

    def step_device(self, chunk: torch.Tensor) -> torch.Tensor:
        """One chunk [chunk_samples] (a host or device tensor) -> the
        converted chunk [chunk_out_samples] on the device, the caller's
        own tensor.  The chunk is copied into the program's static input
        with ``non_blocking=True``: a pinned host chunk must not be
        rewritten before the step's work is done."""
        self._chunk.copy_(chunk, non_blocking=True)
        return self.program()

    def final_f0(self) -> np.ndarray:
        """F0 of the frames that became final in the last step (0 =
        unvoiced), as a host array of the caller's own (the carry is
        updated in place by the next step)."""
        return self._carry.f0_cache[-self._geo.chunk_frames:].to(
            "cpu", copy=True).numpy()

    def add(self, samples: np.ndarray) -> None:
        """Append input PCM at in_rate (any length)."""
        self._in.add(self._written, np.asarray(samples, np.float32))
        self._written += len(samples)

    def process(self) -> np.ndarray:
        """Consume every complete chunk available; return the converted
        PCM at out_rate (possibly empty)."""
        S = self._geo.chunk_in_samples
        out = []
        while self._in_pos + S <= self._written:
            chunk = self._in.fetch(self._in_pos, S)
            self._in.remove(self._in_pos + S)
            self._in_pos += S
            out.append(self.step_device(torch.from_numpy(chunk))
                       .cpu().numpy())
        if not out:
            return np.zeros(0, np.float32)
        return np.concatenate(out)

    def flush(self) -> np.ndarray:
        """Feed zeros to drain the algorithmic latency."""
        So = self._geo.chunk_out_samples
        n_chunks = -(-self.latency_samples // So)
        self.add(np.zeros(n_chunks * self._geo.chunk_in_samples, np.float32))
        return self.process()
