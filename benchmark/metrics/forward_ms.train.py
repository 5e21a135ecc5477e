"""Device ms per traced training step of the forward pass and the losses
(the ``stage_begin_forward`` marker to the next).  Nothing when the trace
holds no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("forward",))
