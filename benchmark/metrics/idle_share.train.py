"""Share (%) of the traced training steps' wall time in which no device
operation ran."""


def read(rec):
    if rec is None or not rec.device:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s())
