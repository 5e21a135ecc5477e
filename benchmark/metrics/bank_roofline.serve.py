"""Kernel 1, the harmonic bank's forward, against its roofline (%): the
least time of the ticks' bank work (``formulas.bank_forward_cost`` at the
tick's rows) over the traced device time of ``harmonic_bank_kernel``.
Nothing when it did not run."""


def _match(name):
    return any(f"harmonic_bank_kernel{c}" in name for c in "<(")


def read(rec):
    if rec is None or "bank_least_s" not in rec.info:
        return None
    t = rec.device_time_s(_match)
    if t <= 0:
        return None
    return 100.0 * rec.info["bank_least_s"] * rec.steps / t
