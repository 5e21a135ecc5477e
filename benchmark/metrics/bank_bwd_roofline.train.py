"""Kernel 4, the harmonic bank's backward, against its roofline (%): the
least time of a step's bank backward work (the joint objective renders
twice, the DDSP and the wave decoder's, each over batch x crop rows, the
amplitudes' gradients only: ``formulas.bank_backward_cost`` with
``phase=False``) over the traced device time of
``harmonic_bank_bwd_kernel``.  Nothing when it did not run."""


def _match(name):
    return any(f"harmonic_bank_bwd_kernel{c}" in name for c in "<(")


def read(rec):
    if rec is None or "bank_bwd_least_s" not in rec.info:
        return None
    t = rec.device_time_s(_match)
    if t <= 0:
        return None
    return 100.0 * rec.info["bank_bwd_least_s"] * rec.steps / t
