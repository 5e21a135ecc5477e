"""Device ms per traced serving tick of the lane masks on the carry: the
reset mask before the step (``stage_begin_carry_in``) and the live mask
and the carry's store after it (``stage_begin_carry_out`` to
``stage_end``).  Nothing when the trace holds no marker."""

from benchmark import stages


def read(rec):
    return stages.stage_ms(rec, ("carry_in", "carry_out"))
