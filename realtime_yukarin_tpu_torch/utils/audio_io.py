"""WAV file I/O (stdlib ``wave`` + NumPy; a copy of the JAX package's
``utils/audio_io.py``, which the port does not import).

8/16/32-bit PCM WAV, mono (channels are averaged); polyphase resampling
via scipy when the file's rate differs from the one asked for.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str, target_rate: int | None = None
             ) -> tuple[np.ndarray, int]:
    """Returns (float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if target_rate is not None and target_rate != rate:
        from scipy.signal import resample_poly
        from math import gcd
        g = gcd(target_rate, rate)
        x = resample_poly(x, target_rate // g, rate // g).astype(np.float32)
        rate = target_rate
    return x, rate


def write_wav(path: str, x: np.ndarray, rate: int) -> None:
    """Write float32 mono samples as 16-bit PCM."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def read_raw_f32(stream, num_samples: int) -> np.ndarray | None:
    """Read exactly num_samples float32 from a binary stream (socket/pipe
    front-end for realtime serving); None on EOF."""
    need = num_samples * 4
    buf = b""
    while len(buf) < need:
        chunk = stream.read(need - len(buf))
        if not chunk:
            return None
        buf += chunk
    return np.frombuffer(buf, dtype="<f4").copy()


def write_raw_f32(stream, x: np.ndarray) -> None:
    stream.write(np.asarray(x, "<f4").tobytes())
    stream.flush()
