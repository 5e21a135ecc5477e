"""Device ms per traced serving tick of the render (the ``stage_begin_render``
marker to the next): the frame noise and the vocoder, the DSP renderer with
the harmonic bank (kernel 1) in the dsp mode.  Nothing when the trace holds
no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("render",))
