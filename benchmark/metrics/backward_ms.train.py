"""Device ms per traced training step of the gradients (the
``stage_begin_backward`` marker to the next), the bank's backward (kernel
4) among them.  Nothing when the trace holds no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("backward",))
