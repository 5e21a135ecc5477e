"""The HiFi-GAN generator against its roofline (%): its least time a tick
(``formulas_hifigan.generator_least_s`` over every lane's rows: each
layer's larger of FLOPs over the bf16 peak and bytes over HBM bandwidth,
summed) over the traced device time of its stages (``vocoder_ms.serve``).
Nothing when the cell runs no generator or the trace holds no marker."""

from benchmark import stages

STAGES = ("vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3", "vocoder_s4")


def read(rec):
    if rec is None or "vocoder_least_s" not in rec.info:
        return None
    ms = stages.stage_ms(rec, STAGES)
    if not ms:
        return None
    return 100.0 * rec.info["vocoder_least_s"] / (ms / 1e3)
