"""Live mic -> speaker front-end — the reference's PyAudio loop (PyTorch
port of ``runtime/live_audio.py``).

``upstream:run.py`` opens PyAudio input+output streams, pushes mic chunks
into the worker pipeline and plays converted chunks back, padding silence
when the pipeline falls behind.  Here the capture callback pushes PCM into
:class:`PipelinedStream`'s native input ring, the playback callback pops
converted PCM from the output ring (silence-on-underrun is the ring's pop
contract), and the device step runs in between on the dispatch thread.
Audio callbacks never touch torch or Python locks — the same
single-producer/single-consumer discipline as the reference's queue
topology.

No audio library is a hard dependency (the build environment is headless):
the backend is resolved lazily — ``sounddevice`` first, then ``pyaudio`` —
and the CLI degrades to pipe/wav/socket front-ends when neither exists.
Device selection is by name substring or index, matching the reference
config's audio device names (``upstream:realtime_voice_conversion/config.py``).

A *backend* is any object with this small surface (duck-typed so tests can
inject a fake and CI can run the whole live loop headlessly):

- ``list_devices() -> list[dict]`` with keys ``index``, ``name``,
  ``max_input_channels``, ``max_output_channels``
- ``input_stream(rate, block, device_index, callback)`` → context manager;
  while open, ``callback(pcm: np.float32 [n])`` fires from the audio thread
- ``output_stream(rate, block, device_index, callback)`` → context manager;
  while open, ``callback(n) -> np.float32 [n]`` must return exactly n
  samples (silence when starved)
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.runtime.pipelined import PipelinedStream


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class SounddeviceBackend:
    """python-sounddevice (PortAudio) adapter."""

    def __init__(self, sd=None):
        if sd is None:                                 # pragma: no cover
            import sounddevice as sd
        self._sd = sd

    def list_devices(self) -> list[dict]:
        out = []
        for i, d in enumerate(self._sd.query_devices()):
            out.append({"index": i, "name": d["name"],
                        "max_input_channels": d["max_input_channels"],
                        "max_output_channels": d["max_output_channels"]})
        return out

    def input_stream(self, rate: int, block: int, device_index: int | None,
                     callback: Callable[[np.ndarray], None]):
        def cb(indata, frames, time_info, status):
            callback(np.ascontiguousarray(indata[:, 0], dtype=np.float32))

        return self._sd.InputStream(samplerate=rate, blocksize=block,
                                    device=device_index, channels=1,
                                    dtype="float32", callback=cb)

    def output_stream(self, rate: int, block: int, device_index: int | None,
                      callback: Callable[[int], np.ndarray]):
        def cb(outdata, frames, time_info, status):
            outdata[:, 0] = callback(frames)

        return self._sd.OutputStream(samplerate=rate, blocksize=block,
                                     device=device_index, channels=1,
                                     dtype="float32", callback=cb)


class _PyAudioStreamCM:
    """start/stop/close context manager over a PyAudio stream."""

    def __init__(self, stream):
        self._stream = stream

    def __enter__(self):
        self._stream.start_stream()
        return self

    def __exit__(self, *exc):
        self._stream.stop_stream()
        self._stream.close()


class PyAudioBackend:
    """PyAudio (PortAudio) adapter — the reference's own audio library."""

    def __init__(self, pyaudio_module=None):
        if pyaudio_module is None:                     # pragma: no cover
            import pyaudio as pyaudio_module
        self._pa_mod = pyaudio_module
        self._pa = pyaudio_module.PyAudio()

    def list_devices(self) -> list[dict]:
        out = []
        for i in range(self._pa.get_device_count()):
            d = self._pa.get_device_info_by_index(i)
            out.append({"index": i, "name": d["name"],
                        "max_input_channels": d["maxInputChannels"],
                        "max_output_channels": d["maxOutputChannels"]})
        return out

    def input_stream(self, rate, block, device_index, callback):
        cont = self._pa_mod.paContinue

        def cb(in_data, frame_count, time_info, status):
            callback(np.frombuffer(in_data, np.float32))
            return (None, cont)

        return _PyAudioStreamCM(self._pa.open(
            format=self._pa_mod.paFloat32, channels=1, rate=rate, input=True,
            frames_per_buffer=block, input_device_index=device_index,
            stream_callback=cb, start=False))

    def output_stream(self, rate, block, device_index, callback):
        cont = self._pa_mod.paContinue

        def cb(in_data, frame_count, time_info, status):
            return (np.asarray(callback(frame_count),
                               np.float32).tobytes(), cont)

        return _PyAudioStreamCM(self._pa.open(
            format=self._pa_mod.paFloat32, channels=1, rate=rate,
            output=True, frames_per_buffer=block,
            output_device_index=device_index, stream_callback=cb,
            start=False))


def load_backend(name: str = "auto"):
    """Resolve an audio backend lazily; raise with guidance when headless."""
    errors: list[str] = []
    if name in ("auto", "sounddevice"):
        try:
            return SounddeviceBackend()
        except Exception as e:                         # pragma: no cover
            errors.append(f"sounddevice: {e}")
    if name in ("auto", "pyaudio"):
        try:
            return PyAudioBackend()
        except Exception as e:                         # pragma: no cover
            errors.append(f"pyaudio: {e}")
    raise RuntimeError(
        "no live-audio backend available (tried: "
        + "; ".join(errors or [name])
        + ") — install python-sounddevice or PyAudio, or use the pipe/wav/"
        "socket front-ends (cli.serve without --live)")


# ---------------------------------------------------------------------------
# Device selection (reference config: audio device names)
# ---------------------------------------------------------------------------

def resolve_device(devices: list[dict], query: str | int | None,
                   kind: str) -> int | None:
    """Device index from a name substring or index; None = system default.

    ``kind`` is "input" or "output"; only devices with channels of that
    kind are eligible (a speaker can't be picked as a mic by accident).
    """
    if query is None or query == "":
        return None
    key = f"max_{kind}_channels"
    eligible = [d for d in devices if d.get(key, 0) > 0]
    if isinstance(query, int) or (isinstance(query, str)
                                  and query.isdigit()):
        idx = int(query)
        if not any(d["index"] == idx for d in eligible):
            raise ValueError(
                f"device index {idx} is not an {kind} device; "
                f"available: {[(d['index'], d['name']) for d in eligible]}")
        return idx
    q = str(query).lower()
    matches = [d for d in eligible if q in d["name"].lower()]
    if not matches:
        raise ValueError(
            f"no {kind} device matching {query!r}; "
            f"available: {[(d['index'], d['name']) for d in eligible]}")
    return matches[0]["index"]


def format_device_table(devices: list[dict]) -> str:
    lines = ["idx  in  out  name"]
    for d in devices:
        lines.append(f"{d['index']:>3}  {d['max_input_channels']:>2}  "
                     f"{d['max_output_channels']:>3}  {d['name']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The live session
# ---------------------------------------------------------------------------

class LiveSession:
    """Run mic→pipeline→speaker until stopped.

    The mic runs at ``cfg.dsp.in_rate`` and the speaker at
    ``cfg.dsp.out_rate`` (the step resamples on the device when they
    differ), so a 16 kHz mic / 48 kHz speaker pair needs no host DSP.
    """

    def __init__(self, stream: PipelinedStream, cfg: Config, backend,
                 input_device: str | int | None = None,
                 output_device: str | int | None = None,
                 block_ms: float = 20.0):
        self._stream = stream
        self._cfg = cfg
        self._backend = backend
        devices = backend.list_devices()
        self._in_idx = resolve_device(devices, input_device, "input")
        self._out_idx = resolve_device(devices, output_device, "output")
        self._block_in = max(1, int(cfg.dsp.in_rate * block_ms / 1000.0))
        self._block_out = max(1, int(cfg.dsp.out_rate * block_ms / 1000.0))

    def run(self, duration: float | None = None,
            stop: threading.Event | None = None,
            poll_s: float = 0.05) -> None:
        """Open both audio streams and block until ``duration`` elapses or
        ``stop`` is set (Ctrl-C also stops)."""
        stop = stop or threading.Event()
        stream = self._stream
        backend = self._backend

        inp = backend.input_stream(self._cfg.dsp.in_rate, self._block_in,
                                   self._in_idx, stream.push_input)
        out = backend.output_stream(self._cfg.dsp.out_rate, self._block_out,
                                    self._out_idx, stream.pop_output)
        deadline = None if duration is None else time.monotonic() + duration
        with inp, out:
            try:
                while not stop.is_set():
                    if deadline is not None and time.monotonic() >= deadline:
                        break
                    time.sleep(poll_s)
            except KeyboardInterrupt:                  # pragma: no cover
                pass
