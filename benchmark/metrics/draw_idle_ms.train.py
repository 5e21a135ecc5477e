"""Device-idle ms per traced training step inside the program's
``host.data.draw`` span: the corpus sampler's host crops and noise draw,
which nothing on the device overlaps.  Nothing without the span."""

from benchmark import stages


def read(rec):
    return stages.idle_ms_in(rec, "host.data.draw")
