"""Device ms per traced serving tick of the analysis stage (from the
program's ``stage_begin_analysis`` marker to the next): the wave buffer's
roll, F0 and its candidates, the snap, the power spectrogram (kernel 2),
the voicing revision, the envelope and aperiodicity (kernel 3) and the
caches' concatenation.  Nothing when the trace holds no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("analysis",))
