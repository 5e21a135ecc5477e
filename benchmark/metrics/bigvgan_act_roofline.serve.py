"""The BigVGAN generator's anti-aliased activation kernel against its
roofline (%): the activation passes' least time a tick
(``formulas_bigvgan.act_least_s``: per pass the larger of its bytes over
HBM bandwidth and its FLOPs over the float32 peak) over the traced device
time of the kernels named ``bigvgan_act_kernel`` (``csrc/bigvgan_act.cu``;
the passes without an activation, ``hifigan_tail_kernel``'s, are not
counted).
Nothing when the cell runs no BigVGAN generator or no such kernel ran."""


def _match(name):
    return any(f"bigvgan_act_kernel{c}" in name for c in "<(")


def read(rec):
    if rec is None or "bigvgan_act_least_s" not in rec.info:
        return None
    t = rec.device_time_s(_match)
    if t <= 0:
        return None
    return 100.0 * rec.info["bigvgan_act_least_s"] * rec.steps / t
