"""Dispatch-ahead pipelined realtime server (PyTorch port of
``runtime/pipelined.py``).

One stream's chunks go input ring -> device step -> output ring on a
background dispatch thread that keeps up to ``depth`` chunks in flight.
The step is a :class:`VoiceChangerStream`'s captured program, made (and on
CUDA captured) in the constructor before the thread starts, and replayed
on the dispatch thread's CUDA stream.  Each in-flight chunk has its own
pinned staging buffers: its input is copied from one with
``non_blocking=True``, and its output into another after the replay, then
a CUDA event is recorded; the thread waits only on the event of the chunk
``depth`` steps back, whose buffers the next chunk reuses, so the host's
feed, the device's compute and the copy back of consecutive chunks
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

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.runtime import RingBuffer
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.utils.metrics import ServingMetrics


class _Fetch:
    """A step's output on its way to the host: on a GPU copied by a
    non-blocking copy into ``host`` (a pinned staging buffer), and the
    event recorded after it."""

    def __init__(self, y: torch.Tensor, host: torch.Tensor | None):
        if host is not None:
            host.copy_(y, non_blocking=True)
            self._host = host
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
                 seed: int = 0, depth: int = 2, ring_seconds: float = 4.0,
                 vocoder_mode: str = "dsp", device=None):
        # the step's program: built (kernels compiled, step captured on
        # CUDA) here, before the dispatch thread starts
        self._stream = VoiceChangerStream(
            params, cfg, use_sr, seed=seed, vocoder_mode=vocoder_mode,
            device=device)
        self.device = self._stream.device
        self.program = self._stream.program
        self._depth = max(1, depth)
        # the dispatch thread runs on the stream current here, named
        # explicitly: a thread's current stream is its own
        self._cuda_stream = None
        # pinned staging, one input and one output buffer per chunk in
        # flight (depth + 1: chunk k reuses chunk k - depth - 1's, whose
        # event was waited on before chunk k is dispatched)
        self._stage_in = self._stage_out = [None] * (self._depth + 1)
        if self.device.type == "cuda":
            self._cuda_stream = torch.cuda.current_stream(self.device)
            self._stage_in = [
                torch.empty(self.chunk_samples, pin_memory=True)
                for _ in range(self._depth + 1)]
            self._stage_out = [
                torch.empty(self.chunk_out_samples, pin_memory=True)
                for _ in range(self._depth + 1)]

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
        return self._stream.chunk_samples

    @property
    def chunk_out_samples(self) -> int:
        return self._stream.chunk_out_samples

    @property
    def latency_samples(self) -> int:
        """End-to-end delay in OUTPUT-rate samples."""
        return self._stream.latency_samples

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
        then wait until everything reached the output ring."""
        S = self.chunk_samples
        n_lat = -(-self.latency_samples // self.chunk_out_samples)
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
        S = self.chunk_samples
        inflight: list[tuple[float, _Fetch]] = []
        k = 0

        def retire_oldest():
            t_in, fetch = inflight.pop(0)
            self._out_rb.push(fetch.wait())
            self.metrics.chunk_latency.record(1000 * (time.perf_counter()
                                                      - t_in))

        while not self._stop.is_set():
            if self._in_rb.available >= S:
                chunk, _ = self._in_rb.pop_chunk_or_silence(S)
                t0 = time.perf_counter()
                slot = k % (self._depth + 1)
                k += 1
                x = torch.from_numpy(chunk)
                if self._stage_in[slot] is not None:
                    x = self._stage_in[slot].copy_(x)
                y = self._stream.step_device(x)
                inflight.append((t0, _Fetch(y, self._stage_out[slot])))
                self.metrics.dispatch_latency.record(
                    1000 * (time.perf_counter() - t0))
                if len(inflight) > self._depth:
                    retire_oldest()
            elif inflight:
                retire_oldest()                        # idle: drain early
            elif self._flushing.is_set():
                # the flush's input lands before its flag is set, but may
                # have landed after the first check of this pass
                if self._in_rb.available < S:
                    self._drained.set()
                    self._flushing.clear()
            else:
                time.sleep(0.0005)
        while inflight:
            retire_oldest()
