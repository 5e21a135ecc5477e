"""The BigVGAN generator against its roofline (%): its least time a tick
over every lane and the rows of its dependency cone
(``formulas_bigvgan.generator_least_s``: per convolution the larger of
FLOPs over the bf16 peak and bytes over HBM bandwidth, per activation its
FLOPs over the float32 peak, summed) over the traced device time of its
stages (``bigvgan_ms.serve``).  Nothing when the cell runs no BigVGAN
generator or the trace holds no marker."""

from benchmark import stages

STAGES = ("vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3", "vocoder_s4",
          "vocoder_s5", "vocoder_s6")


def read(rec):
    if rec is None or "bigvgan_least_s" not in rec.info:
        return None
    ms = stages.stage_ms(rec, STAGES)
    if not ms:
        return None
    return 100.0 * rec.info["bigvgan_least_s"] / (ms / 1e3)
