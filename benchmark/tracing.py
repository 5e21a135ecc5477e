"""The traced run's records: ``torch.profiler`` over a few consecutive steps
in mid-window, the cell's host spans (``record_function`` ranges named
``host.*``) and its counters, and the reductions the metric readers share.

All times are the profiler's microseconds (host and device on one clock).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

HOST_PREFIX = "host."
# GPU-side copies of user annotations, and the ``Module#method`` names some
# builds give them; neither is device work
_ANNOTATION = re.compile(r"^[\w.]+#[\w.]+$")


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


@dataclasses.dataclass
class Records:
    """device: [(name, start, end)] of every kernel, copy and fill;
    host: [(name, start, end)] of the cell's host spans; steps: steps traced;
    counters: what the driver counted over those steps; info: the cell's
    shapes the readers need (``formulas.py``)."""

    device: list
    host: list
    steps: int
    counters: dict
    info: dict

    def spans(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for n, s, e in self.host if n == name]

    def window(self) -> tuple[float, float]:
        """From the first traced step's start to the end of the last one,
        its device work included."""
        steps = self.spans("host.step")
        end = max(e for _, e in steps)
        if self.device:
            end = max(end, max(e for _, _, e in self.device))
        return min(s for s, _ in steps), end

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) / 1e6

    def device_intervals(self, lo=None, hi=None):
        w = self.window()
        lo = w[0] if lo is None else lo
        hi = w[1] if hi is None else hi
        return clip([(s, e) for _, s, e in self.device], lo, hi)

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        return covered(self.device_intervals()) / 1e6

    def kernels(self) -> list:
        """Kernels only (no copies or fills)."""
        return [d for d in self.device
                if not d[0].startswith(("Memcpy", "Memset"))]

    def device_time_s(self, match) -> float:
        """Summed device seconds of the operations whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host span they fall in."""
        by: dict[str, float] = {}
        for n, s, e in self.device:
            by[n[:160]] = by.get(n[:160], 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        lo, hi = self.window()
        busy = union(self.device_intervals())
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        spans = self.host
        idle: dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = [h for h in spans if h[1] <= mid <= h[2]]
            name = (min(inside, key=lambda h: h[2] - h[1])[0] if inside
                    else "between steps")
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gap_list]}


class Tracer:
    """Profiles ``steps`` consecutive steps once the window is half through
    (``--trace 1``); a no-op otherwise.

    The profiler is started in set-up (:meth:`start`) and kept warm (its
    device tracing on, nothing kept) until the window is half through, so
    its own start-up is paid in set-up, not inside the window.  A driver
    calls :meth:`begin` before each step with the window's elapsed share,
    wraps its host phases in :meth:`span` and calls :meth:`end` after each
    step; :meth:`finish` returns the records."""

    def __init__(self, enabled: bool, steps: int, device):
        self.enabled, self.steps, self.device = enabled, steps, device
        self.prof = None
        self.n = 0                   # steps ended since start()
        self.first = None            # first recorded step
        self.records: Records | None = None
        self.counters: dict = {}
        self.info: dict = {}

    @property
    def active(self) -> bool:
        """Whether the current step is recorded."""
        return (self.first is not None and self.records is None
                and self.n >= self.first)

    def _schedule(self, n: int):
        from torch.profiler import ProfilerAction
        if self.first is None or n < self.first:
            return ProfilerAction.WARMUP
        if n < self.first + self.steps - 1:
            return ProfilerAction.RECORD
        if n == self.first + self.steps - 1:
            return ProfilerAction.RECORD_AND_SAVE
        return ProfilerAction.NONE

    def start(self) -> None:
        """Start the profiler, warm, in set-up."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, schedule=self._schedule,
                            on_trace_ready=self._ready)
        self.prof.__enter__()

    def begin(self, share: float) -> None:
        if self.prof is not None and self.first is None and share >= 0.5:
            self.first = self.n + 1

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def count(self, name: str, value: float) -> None:
        """Add ``value`` to a counter of the recorded steps."""
        if self.active:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def end(self) -> None:
        if self.prof is None:
            return
        edge = self.first is not None and self.records is None and (
            self.n + 1 == self.first
            or self.n == self.first + self.steps - 1)
        if edge and self.device.type == "cuda":
            # the device is idle when recording starts, and the last
            # recorded step's work is in the record
            import torch
            torch.cuda.synchronize(self.device)
        self.n += 1
        self.prof.step()

    def _ready(self, prof) -> None:
        # read in finish(), after the window: parsing the trace takes
        # seconds
        self.records = prof

    def collect(self, prof) -> Records:
        import torch
        dev_t = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == dev_t:
                if (getattr(e, "is_user_annotation", False)
                        or _ANNOTATION.match(e.name)
                        or e.name.startswith(HOST_PREFIX)):
                    continue
                device.append((e.name, float(start), float(end)))
            elif e.name.startswith(HOST_PREFIX):
                host.append((e.name, float(start), float(end)))
        return Records(device=device, host=host, steps=self.steps,
                       counters=dict(self.counters), info=dict(self.info))

    def finish(self) -> Records:
        """Stop the profiler; the records.  A window that ended before its
        recorded steps did raises (the run then gives no result)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None
        if self.records is None:
            raise RuntimeError("the window closed before the traced steps "
                               "ran: lengthen --seconds")
        if not isinstance(self.records, Records):
            self.records = self.collect(self.records)
        return self.records
