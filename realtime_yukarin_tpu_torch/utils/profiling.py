"""Tracing and profiling hooks (PyTorch port of ``utils/profiling.py``).

``trace(dir)`` wraps any region in a ``torch.profiler`` trace of the host
and, on a GPU, the device (CUDA kernels with their names), written as a
Chrome trace (``trace.json``, viewable in Perfetto or chrome://tracing).
A captured step (``streaming/program.py``) shows on the host as one graph
launch and its copies, and its kernels on the device one by one (CUPTI
lists a replayed graph's kernels; ``chip_smoke.py`` phase 19 fails where
it does not).

The program labels its own work in two ways, both on the profiler's clock:

* ``span(name)``: a host phase, named ``host.<layer>.<phase>`` (the
  batched server's copies in and out, a program's call, the training
  step's copy in, the corpus's draws and copies, the socket ticker's
  phases).  With no profiler running it is a shared null context, so the
  spans cost one flag test each.
* ``mark(stage, like)``: a stage marker, an empty kernel named
  ``stage_begin_<stage>`` (or ``stage_end``) launched on the device's
  current stream (``csrc/stage_mark.cu``).  A host range cannot label the
  kernels inside a graph replay, so the markers are captured into the
  graph as kernel nodes, always, and every device operation between two
  markers belongs to the first one's stage.  A serving step marks
  ``SERVE_STAGES`` then ``end`` (9 markers), a training step
  ``TRAIN_STAGES`` then ``end`` (4).  In the hifigan and bigvgan vocoder
  modes a serving step marks ``vocoder``, one ``vocoder_s<i>`` per
  upsampling stage (four and six) and ``vocoder`` again (conv_post) where
  the others mark ``sr`` and ``render``: they run no SR.  On the CPU ``mark`` does nothing.

Usage:
    with trace("/tmp/torch-trace"):         # or serve --profile_dir ...
        server.step(chunks)
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import profiler as _autograd_profiler

from realtime_yukarin_tpu_torch.ops import cuda

SERVE_STAGES = ("carry_in", "resample_in", "analysis", "stage1", "sr",
                "render", "resample_out", "carry_out")
TRAIN_STAGES = ("forward", "backward", "optimizer")
VOCODER_STAGES = ("vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3",
                  "vocoder_s4", "vocoder_s5", "vocoder_s6")
# the markers' indices in csrc/stage_mark.cu; "end" is stage_end
STAGES = SERVE_STAGES + TRAIN_STAGES + VOCODER_STAGES + ("end",)
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace over the with-block, written to
    ``log_dir/trace.json``; a no-op when log_dir is None.  Host ranges are
    recorded on every thread: the socket server steps on its ticker
    thread."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A host span ``name`` (``host.<layer>.<phase>``) while a profiler
    records; otherwise a shared null context that records nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def _launch_marker(stage: str, like: torch.Tensor) -> None:
    if like.is_cuda:
        cuda.STAGE_MARK.call(_STAGE_INDEX[stage])


def mark(stage: str, like: torch.Tensor) -> None:
    """Mark the beginning of ``stage`` (one of ``STAGES``; ``"end"`` after
    a step's last operation) on the device of ``like``: an empty kernel on
    the current stream, captured into a graph like any other.  Nothing on
    the CPU.  Raises KeyError for a stage not in ``STAGES``."""
    if stage not in _STAGE_INDEX:
        raise KeyError(f"no stage {stage!r}; the stages are {STAGES}")
    _launch_marker(stage, like)
