"""Device ms per traced training step of the per-stage clip and AdamW (the
``stage_begin_optimizer`` marker to ``stage_end``).  Nothing when the
trace holds no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("optimizer",))
