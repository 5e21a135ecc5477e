"""What the program marks inside its steps, read from a traced run: the
device time of each stage of a step, and the device's idle time inside one
of the program's own host spans.

The program launches an empty kernel named ``stage_begin_<stage>`` on the
step's stream before each stage and ``stage_end`` after the step's last
operation, captured into its CUDA graph like any other kernel.  One stream
runs a step's operations in order, so each device operation that starts
after a marker and before the next belongs to that marker's stage; the
markers themselves, and what runs before a step's first marker or after its
``stage_end`` (the copies in and out, the output's clone), belong to none.
The program's host spans are ``host.<layer>.<phase>`` ranges, which
``tracing.Records`` keeps with the cell's own.

A program that marks nothing, or lacks the span, gives nothing to read:
the readers then return None.  All times in the records are microseconds.
"""

from __future__ import annotations

import re

from benchmark import tracing

# a marker's kernel name (extern "C", so exact; a demangler may add
# "void " and "()")
_MARK = re.compile(r"^(?:void )?stage_(?:begin_([a-z0-9_]+)|end)(?:\(\))?$")


def split(ops) -> dict[str, float]:
    """{stage: summed duration} of the operations ``ops`` [(name, start,
    end)], each charged to the marker that began last before it; a stage
    that was marked and ran nothing reads 0.  Empty when no marker is among
    ``ops``."""
    out: dict[str, float] = {}
    stage, marked = None, False
    for name, s, e in sorted(ops, key=lambda op: op[1]):
        m = _MARK.match(name)
        if m:
            marked, stage = True, m.group(1)     # None at stage_end
            if stage is not None:
                out.setdefault(stage, 0.0)
        elif stage is not None:
            out[stage] += e - s
    return out if marked else {}


def stage_ms(rec, names) -> float | None:
    """Device ms per traced step of the stages ``names`` together; None
    when the trace holds no marker."""
    if rec is None or not rec.steps:
        return None
    per = split(rec.device)
    if not per:
        return None
    return sum(per.get(n, 0.0) for n in names) / rec.steps / 1e3


def idle_ms_in(rec, span: str) -> float | None:
    """Device-idle ms per traced step inside the intervals of host span
    ``span``, clipped to the traced window; None when the span is absent or
    no device operation was traced."""
    if rec is None or not rec.steps or not rec.device:
        return None
    spans = rec.spans(span)
    if not spans:
        return None
    lo, hi = rec.window()
    busy = tracing.union(rec.device_intervals())
    idle = 0.0
    for s, e in tracing.union(tracing.clip(spans, lo, hi)):
        idle += (e - s) - tracing.covered(tracing.clip(busy, s, e))
    return idle / rec.steps / 1e3
