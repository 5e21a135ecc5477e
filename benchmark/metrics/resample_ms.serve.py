"""Device ms per traced serving tick of the resamplers: the client chunk to
the internal rate (``stage_begin_resample_in``) and the converted chunk
back (``stage_begin_resample_out``).  Nothing when the trace holds no
marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("resample_in", "resample_out"))
