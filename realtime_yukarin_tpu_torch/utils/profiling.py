"""Tracing and profiling hooks (PyTorch port of ``utils/profiling.py``).

``trace(dir)`` wraps any region in a ``torch.profiler`` trace of the host
and, on a GPU, the device (CUDA kernels with their names), written as a
Chrome trace (``trace.json``, viewable in Perfetto or chrome://tracing);
``annotate(name)`` labels host-side phases and ``step_annotation(i)``
marks one serving or training step, so chunk boundaries show beside the
device's kernels.  A captured step (``streaming/program.py``) shows on the
host as one graph launch and its copies, and its kernels on the device
one by one (CUPTI lists a replayed graph's kernels; ``chip_smoke.py``
phase 19 fails where it does not).

Usage:
    with trace("/tmp/torch-trace"):         # or serve --profile_dir ...
        server.step(chunks)
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace over the with-block, written to
    ``log_dir/trace.json``; a no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named host-span context manager; shows up on the trace timeline."""
    return torch.profiler.record_function(name)


def step_annotation(step: int):
    """Marks one serving/training step on the trace timeline."""
    return torch.profiler.record_function(f"step#{step}")
