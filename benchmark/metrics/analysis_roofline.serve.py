"""Kernels 2-3 (the power spectrum and the envelope cepstrum) against
their roofline (%): the least time of the ticks' analysis work
(``formulas.analysis_least_s`` at the tick's rows) over the traced device
time of the kernels named ``power_spectrum_kernel`` and
``envelope_cepstrum_kernel``.  Nothing when neither ran."""

NAMES = ("power_spectrum_kernel", "envelope_cepstrum_kernel")


def _match(name):
    return any(f"{k}{c}" in name for k in NAMES for c in "<(")


def read(rec):
    if rec is None or "analysis_least_s" not in rec.info:
        return None
    t = rec.device_time_s(_match)
    if t <= 0:
        return None
    return 100.0 * rec.info["analysis_least_s"] * rec.steps / t
