"""ctypes binding and on-demand build of the native host runtime (PyTorch
port of ``runtime/__init__.py``).

The host-side native layer is the realtime-safe buffering and file I/O of
``native_runtime.cpp``: a lock-free single-producer/single-consumer float
ring buffer and WAV reading and writing.  At first use the source is
compiled by ``g++`` into ``_build/native_runtime-<hash>.so`` inside the
package (listed in ``.gitignore``), never next to the source; the hash
covers the source and the flags, so an edited source rebuilds.  The flags
are portable (no ``-march=native``), so a library built on one host loads
on another.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "native_runtime.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"native_runtime-{digest[:12]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is built; returns its path.  The
    compiler writes a file of its own, renamed into place, so processes
    that build at once do not see each other's half-written library."""
    final = library_path()
    if final.exists():
        return final
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.parent / f"{final.name}.{os.getpid()}.tmp"
    out = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name}:\n{out.stderr}")
    os.replace(tmp, final)
    return final


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u64 = ctypes.c_uint64
    i64 = ctypes.c_int64
    ptr = ctypes.c_void_p
    fptr = ctypes.POINTER(ctypes.c_float)

    lib.rb_create.restype = ptr
    lib.rb_create.argtypes = [u64]
    lib.rb_destroy.restype = None
    lib.rb_destroy.argtypes = [ptr]
    lib.rb_capacity.restype = u64
    lib.rb_capacity.argtypes = [ptr]
    lib.rb_available.restype = u64
    lib.rb_available.argtypes = [ptr]
    lib.rb_free_space.restype = u64
    lib.rb_free_space.argtypes = [ptr]
    lib.rb_push.restype = u64
    lib.rb_push.argtypes = [ptr, fptr, u64]
    lib.rb_pop.restype = u64
    lib.rb_pop.argtypes = [ptr, fptr, u64]
    lib.rb_pop_exact_or_silence.restype = ctypes.c_int
    lib.rb_pop_exact_or_silence.argtypes = [ptr, fptr, u64]
    lib.rb_underruns.restype = u64
    lib.rb_underruns.argtypes = [ptr]
    lib.rb_overruns.restype = u64
    lib.rb_overruns.argtypes = [ptr]

    class WavInfo(ctypes.Structure):
        _fields_ = [("sample_rate", ctypes.c_int32),
                    ("channels", ctypes.c_int32),
                    ("bits", ctypes.c_int32),
                    ("num_frames", ctypes.c_int64),
                    ("format", ctypes.c_int32)]

    lib.WavInfo = WavInfo
    lib.wav_read_info.restype = ctypes.c_int
    lib.wav_read_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(WavInfo)]
    lib.wav_read_f32.restype = i64
    lib.wav_read_f32.argtypes = [ctypes.c_char_p, fptr, i64]
    lib.wav_write_f32.restype = ctypes.c_int
    lib.wav_write_f32.argtypes = [ctypes.c_char_p, fptr, i64, ctypes.c_int32]
    return lib


_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
    return _lib


def _as_fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """Lock-free SPSC float32 ring buffer (native).

    Producer and consumer may live on different threads; silence-on-
    underrun mirrors the reference's realtime output contract.  The
    capacity is ``min_capacity`` rounded up to a power of two.
    """

    def __init__(self, min_capacity: int):
        self._lib = lib()
        self._h = self._lib.rb_create(min_capacity)
        if not self._h:
            raise MemoryError(f"rb_create({min_capacity}) failed")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.rb_destroy(h)

    @property
    def capacity(self) -> int:
        return self._lib.rb_capacity(self._h)

    @property
    def available(self) -> int:
        return self._lib.rb_available(self._h)

    @property
    def free_space(self) -> int:
        return self._lib.rb_free_space(self._h)

    @property
    def underruns(self) -> int:
        return self._lib.rb_underruns(self._h)

    @property
    def overruns(self) -> int:
        return self._lib.rb_overruns(self._h)

    def push(self, x: np.ndarray) -> int:
        """Append as much of x as fits; returns the samples taken."""
        x = np.ascontiguousarray(x, np.float32)
        return self._lib.rb_push(self._h, _as_fptr(x), len(x))

    def pop(self, n: int) -> np.ndarray:
        """Up to n samples."""
        out = np.empty(n, np.float32)
        got = self._lib.rb_pop(self._h, _as_fptr(out), n)
        return out[:got]

    def pop_chunk_or_silence(self, n: int) -> tuple[np.ndarray, bool]:
        """Exactly-n pop; zeros + False when starved."""
        out = np.empty(n, np.float32)
        ok = self._lib.rb_pop_exact_or_silence(self._h, _as_fptr(out), n)
        return out, bool(ok)


def read_wav_native(path: str) -> tuple[np.ndarray, int]:
    L = lib()
    info = L.WavInfo()
    rc = L.wav_read_info(str(path).encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"wav_read_info({path}) -> {rc}")
    out = np.empty(info.num_frames, np.float32)
    got = L.wav_read_f32(str(path).encode(), _as_fptr(out), info.num_frames)
    if got < 0:
        raise IOError(f"wav_read_f32({path}) -> {got}")
    return out[:got], int(info.sample_rate)


def write_wav_native(path: str, x: np.ndarray, sample_rate: int) -> None:
    L = lib()
    x = np.ascontiguousarray(x, np.float32)
    rc = L.wav_write_f32(str(path).encode(), _as_fptr(x), len(x),
                         sample_rate)
    if rc != 0:
        raise IOError(f"wav_write_f32({path}) -> {rc}")
