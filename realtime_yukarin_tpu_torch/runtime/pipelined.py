"""Dispatch-ahead pipelined realtime server (PyTorch port of
``runtime/pipelined.py``).

One stream's chunks go input ring -> device step -> output ring on a
background dispatch thread that keeps up to ``depth`` chunks in flight:
each step's output is copied into a pinned host buffer with
``non_blocking=True`` and a CUDA event is recorded after the copy, and the
thread waits only on the event of the chunk ``depth`` steps back, so the
host's feed, the device's compute and the copy back of consecutive chunks
overlap.  On the CPU the step is synchronous and the output is the host
array itself.

Audio edges are the native lock-free SPSC ring buffers
(``runtime/native_runtime.cpp``): the audio callback thread pushes and pops
without touching Python locks or torch; the dispatch thread is the single
consumer of the input ring and the single producer of the output ring.

Underrun contract: ``pop_output`` emits silence when the pipeline is
behind (the reference's run.py behaviour); silence emissions are counted
in the metrics.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config, resolve_vocoder_mode
from realtime_yukarin_tpu_torch.models.voice_changer import params_to
from realtime_yukarin_tpu_torch.runtime import RingBuffer
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    init_stream, noise_key_from_seed, resolve_device, streaming_step)
from realtime_yukarin_tpu_torch.streaming.state import tree_map
from realtime_yukarin_tpu_torch.utils.metrics import ServingMetrics


class _Fetch:
    """A step's output on its way to the host: on a GPU a pinned buffer
    filled by a non-blocking copy, and the event recorded after it."""

    def __init__(self, y: torch.Tensor):
        if y.device.type == "cuda":
            self._host = torch.empty(y.shape, dtype=y.dtype,
                                     pin_memory=True)
            self._host.copy_(y, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = y, None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class PipelinedStream:
    """Single-stream realtime conversion with dispatch-ahead depth, on
    ``device`` (``cuda`` unless the caller passes another; no fallback).

    Producer thread: ``push_input(pcm)``.  Consumer thread:
    ``pop_output(n)``.  A background dispatch thread moves chunks
    input-ring -> device -> output-ring, keeping ``depth`` chunks in
    flight.  ``flush()`` + ``close()`` end the stream.
    """

    def __init__(self, params: dict, cfg: Config, use_sr: bool = True,
                 use_neural_vocoder: bool = False, seed: int = 0,
                 depth: int = 2, ring_seconds: float = 4.0,
                 warmup: bool = True, vocoder_mode: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        self._params = params_to(params, self.device)
        self._cfg = cfg
        self._use_sr = use_sr
        self._mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)
        self._key = torch.tensor(noise_key_from_seed(seed),
                                 dtype=torch.int64, device=self.device)
        with torch.no_grad():
            self._carry, self._geo = init_stream(
                self._params, cfg, use_sr, vocoder_mode=self._mode,
                device=self.device)
        self._depth = max(1, depth)
        # the dispatch thread runs on the stream current here, named
        # explicitly: a thread's current stream is its own
        self._cuda_stream = (torch.cuda.current_stream(self.device)
                             if self.device.type == "cuda" else None)

        if warmup:
            # build the kernels (nvcc) and run one step before going live,
            # on a copy of the carry: the step is out of place, but the
            # live carry is never handed to a throwaway step
            scratch = tree_map(torch.clone, self._carry)
            with torch.no_grad():
                y, _ = streaming_step(
                    self._params, scratch,
                    torch.zeros(self._geo.chunk_in_samples,
                                device=self.device),
                    self._key, cfg, use_sr, vocoder_mode=self._mode)
            _Fetch(y).wait()

        self._in_rb = RingBuffer(int(ring_seconds * cfg.dsp.in_rate))
        self._out_rb = RingBuffer(int(ring_seconds * cfg.dsp.out_rate))
        self.metrics = ServingMetrics()

        self._stop = threading.Event()
        self._flushing = threading.Event()
        self._drained = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="vc-dispatch")
        self._thread.start()

    # -- audio-edge API ----------------------------------------------------

    @property
    def chunk_samples(self) -> int:
        """Input chunk size (samples at cfg.dsp.in_rate)."""
        return self._geo.chunk_in_samples

    @property
    def chunk_out_samples(self) -> int:
        return self._geo.chunk_out_samples

    @property
    def latency_samples(self) -> int:
        """End-to-end delay in OUTPUT-rate samples."""
        return self._geo.latency_out_samples(self._cfg.dsp)

    def push_input(self, pcm: np.ndarray) -> int:
        """Producer: enqueue PCM; returns samples accepted (drops counted)."""
        pushed = self._in_rb.push(np.asarray(pcm, np.float32))
        if pushed < len(pcm):
            self.metrics.incr("input_overruns")
        return pushed

    def pop_output(self, n: int) -> np.ndarray:
        """Consumer: dequeue exactly n converted samples (silence when
        starved — the reference's underrun contract)."""
        out, ok = self._out_rb.pop_chunk_or_silence(n)
        if not ok:
            self.metrics.incr("output_underruns")
        return out

    def output_available(self) -> int:
        return self._out_rb.available

    # -- lifecycle ---------------------------------------------------------

    def flush(self, timeout: float = 600.0) -> None:
        """Feed silence to drain algorithmic latency + in-flight chunks,
        then wait until everything reached the output ring.  The generous
        default covers a first-use kernel build when warmup was off."""
        S = self._geo.chunk_in_samples
        n_lat = -(-self.latency_samples // self._geo.chunk_out_samples)
        self.push_input(np.zeros((n_lat + 1) * S, np.float32))
        self._flushing.set()
        if not self._drained.wait(timeout):
            self.metrics.incr("flush_timeouts")

    def close(self, timeout: float = 600.0) -> None:
        """Stop the dispatch thread; waits for in-flight device work."""
        self._stop.set()
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch thread ---------------------------------------------------

    def _dispatch_loop(self) -> None:
        if self._cuda_stream is not None:
            with torch.cuda.stream(self._cuda_stream), torch.no_grad():
                self._dispatch()
        else:
            with torch.no_grad():
                self._dispatch()

    def _dispatch(self) -> None:
        S = self._geo.chunk_in_samples
        inflight: list[tuple[float, _Fetch]] = []

        def retire_oldest():
            t_in, fetch = inflight.pop(0)
            self._out_rb.push(fetch.wait())
            self.metrics.chunk_latency.record(1000 * (time.perf_counter()
                                                      - t_in))

        while not self._stop.is_set():
            if self._in_rb.available >= S:
                chunk, _ = self._in_rb.pop_chunk_or_silence(S)
                t0 = time.perf_counter()
                y, self._carry = streaming_step(
                    self._params, self._carry,
                    torch.from_numpy(chunk).to(self.device,
                                               non_blocking=True),
                    self._key, self._cfg, self._use_sr,
                    vocoder_mode=self._mode)
                inflight.append((t0, _Fetch(y)))
                self.metrics.dispatch_latency.record(
                    1000 * (time.perf_counter() - t0))
                if len(inflight) > self._depth:
                    retire_oldest()
            elif inflight:
                retire_oldest()                        # idle: drain early
            elif self._flushing.is_set():
                self._drained.set()
                self._flushing.clear()
            else:
                time.sleep(0.0005)
        while inflight:
            retire_oldest()
