"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C function ``<name>_forward`` (the
launcher) and ``<name>_error_string``.  At first use every source is
compiled by its own ``nvcc`` process, all started together, into
``_build/<name>-<hash>.so`` inside the package (listed in ``.gitignore``);
the hash covers the source and the flags, so an edited source rebuilds.
The libraries are loaded with ``ctypes``.  A launcher takes the tensors'
``data_ptr()`` values and PyTorch's current stream and returns
``cudaGetLastError()``; a non-zero code raises here.

Launches inside a CUDA graph capture (``streaming/program.py``) are
recorded by :func:`capturing` instead of counted, and counted again on
every replay of the graph, so ``launches`` means launches that ran.  The
record is kept per capturing stream, not per thread: a backward captured
with its forward runs on autograd's own worker thread, on the same
stream.

The stage markers (``csrc/stage_mark.cu``, ``utils/profiling.py:mark``)
do no work and are not among ``KERNELS``: they go through
:meth:`CudaKernel.call`, which neither counts nor records, so a program's
launch record and counts stay those of the kernels that compute.
:func:`build` compiles them with the kernels, before any capture.

Nothing is compiled or loaded at import time: the CPU tests import every
module of the port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# No --use_fast_math: the harmonic bank's phase reaches tens of radians,
# where the fast __sinf/__cosf intrinsics lose accuracy.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit on the GPU machine")


def _library_path(name: str) -> pathlib.Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


class CudaKernel:
    """One kernel of ``csrc/``: its ctypes launcher and its launch count.

    ``launches`` is a plain integer that :meth:`count` raises by one each
    time the kernel runs: at an eager :meth:`launch`, or at each replay of
    a graph that captured the launch.  Nothing else changes it except
    :func:`reset_counts`, so a run can show it went through the kernel.
    ``computes`` names the kernel of the port whose work it does: its own
    name, or, for a second design of a kernel (the batch-width designs of
    the power spectrum and the envelope cepstrum), that kernel's.
    """

    def __init__(self, name: str, argtypes: tuple,
                 computes: str | None = None):
        self.name = name
        self.argtypes = argtypes
        self.computes = computes or name
        self.launches = 0
        self._fn = None
        self._err = None

    @property
    def source(self) -> str:
        return str((CSRC_DIR / f"{self.name}.cu").relative_to(
            PACKAGE_DIR.parent))

    def _load(self):
        if self._fn is None:
            build([self])
            lib = ctypes.CDLL(str(_library_path(self.name)))
            fn = getattr(lib, f"{self.name}_forward")
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def call(self, *args) -> int:
        """Call the launcher on the current stream, uncounted; raise on a
        CUDA error.  Returns the stream's handle."""
        fn = self._load()
        stream = current_stream()
        code = fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"{self.name}: CUDA error {code} "
                               f"({self._err(code).decode()})")
        return stream

    def launch(self, *args) -> None:
        """Call the launcher on the current stream; raise on a CUDA error.
        Counted, or recorded by the capture on that stream."""
        stream = self.call(*args)
        capture = _capture_on(stream)
        if capture is not None:
            with _lock:
                capture.launches.append((self, args))
        elif torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{self.name}: launched in a CUDA graph "
                               f"capture outside cuda.capturing(), whose "
                               f"replays would go uncounted")
        else:
            self.count(args)

    def count(self, args: tuple) -> None:
        """One launch of this kernel with these launcher arguments ran
        (without the stream argument)."""
        self.launches += 1


class Capture:
    """What one graph capture on a stream recorded: each kernel launch
    as (kernel, launcher arguments), and the cached device constants the
    captured work reads, which the graph must keep alive because it holds
    their addresses."""

    def __init__(self):
        self.launches: list[tuple[CudaKernel, tuple]] = []
        self.held: list[torch.Tensor] = []

    def replayed(self) -> None:
        """Count the recorded launches once: the graph ran again."""
        for kernel, args in self.launches:
            kernel.count(args)


# the open capture records, by the handle of the stream being captured
_captures: dict[int, Capture] = {}
_lock = threading.Lock()


def current_stream() -> int:
    """The handle of this thread's current CUDA stream."""
    return torch.cuda.current_stream().cuda_stream


def _capture_on(stream: int) -> Capture | None:
    if not _captures:
        return None
    with _lock:
        return _captures.get(stream)


@contextlib.contextmanager
def capturing(stream: int):
    """Record into a fresh :class:`Capture`, instead of counting, every
    launch made in the block on the stream with handle ``stream`` (the
    graph capture's), from whichever thread makes it."""
    capture = Capture()
    with _lock:
        if stream in _captures:
            raise RuntimeError(f"stream {stream:#x} is already recorded")
        _captures[stream] = capture
    try:
        yield capture
    finally:
        with _lock:
            del _captures[stream]


def hold(*tensors: torch.Tensor) -> None:
    """Keep ``tensors`` (cached constants) alive for as long as the graph
    being captured on the current stream, if one is."""
    if not _captures:
        return
    capture = _capture_on(current_stream())
    if capture is not None:
        with _lock:
            capture.held.extend(tensors)


# the bank kernels' ints after (R, H, hop): their tiling,
# ops/harmonic_bank.py:BankPlan.launch_args
HARMONIC_BANK = CudaKernel(
    "harmonic_bank", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P))
POWER_SPECTRUM = CudaKernel(
    "power_spectrum", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
ENVELOPE_CEPSTRUM = CudaKernel(
    "envelope_cepstrum", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                          _P))
HARMONIC_BANK_BWD = CudaKernel(
    "harmonic_bank_bwd", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P))
# the batch-width designs of kernels 2 and 3 (ops/analysis.py picks one
# design or the other by the row count); their ints after (R, n, K) and
# (R, K): the layout, ops/analysis.py:WidePowerPlan / WideCepstrumPlan
POWER_SPECTRUM_WIDE = CudaKernel(
    "power_spectrum_wide", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    computes="power_spectrum")
ENVELOPE_CEPSTRUM_WIDE = CudaKernel(
    "envelope_cepstrum_wide", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                               _P),
    computes="envelope_cepstrum")
# the HiFi-GAN generator's fused tail between two convolutions
# (ops/hifigan_tail.py): y, r, acc, bias, out0, out1, then rows, length, C,
# the operands' row stride, the window's start row, the mode, bfloat16 or
# not, the slope and the divisor
HIFIGAN_TAIL = CudaKernel(
    "hifigan_tail", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                     _F, _P))
# the BigVGAN generator's pass before an activation, the anti-aliased
# activation included (ops/bigvgan_act.py): y, r, acc, bias, alpha,
# inv_beta, the filter, out_v, out_a, then rows, the operand's rows, its
# row stride, the first kept row, the kept rows, C, bfloat16 or not and the
# divisor
BIGVGAN_ACT = CudaKernel(
    "bigvgan_act", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I,
                    _I, _I, _F, _P))
KERNELS = (HARMONIC_BANK, POWER_SPECTRUM, ENVELOPE_CEPSTRUM,
           HARMONIC_BANK_BWD, POWER_SPECTRUM_WIDE, ENVELOPE_CEPSTRUM_WIDE,
           HIFIGAN_TAIL, BIGVGAN_ACT)
# the stage index, utils/profiling.py:STAGES
STAGE_MARK = CudaKernel("stage_mark", (_I, _P))


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def build(kernels=KERNELS + (STAGE_MARK,)) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all at once
    (by default every source: the kernels and the stage markers).

    Returns {kernel name: nvcc's ``-Xptxas -v`` report} for the sources
    compiled by this call (empty where the library was already built).
    """
    todo = [k for k in kernels if not _library_path(k.name).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in todo:
        final = _library_path(k.name)
        tmp = final.parent / f"{final.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{k.name}.cu")]
        procs.append((k, tmp, final, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for k, tmp, final, proc in procs:
        out, _ = proc.communicate()
        reports[k.name] = out
        if proc.returncode != 0:
            failed.append(f"{k.name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, final)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports



def check(t: torch.Tensor, name: str, shape: tuple, device: torch.device
          ) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` — what every kernel launcher takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
