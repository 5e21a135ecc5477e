"""Device ms per traced serving tick of the envelope super-resolution (the
``stage_begin_sr`` marker to the next; 0 with SR off).  Nothing when the
trace holds no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("sr",))
