"""Device ms per traced serving tick of stage 1 (the ``stage_begin_stage1``
marker to the next): the streamed mel-cepstrum conversion, the F0
statistics and the mel-cepstrum decode.  Nothing when the trace holds no
marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("stage1",))
