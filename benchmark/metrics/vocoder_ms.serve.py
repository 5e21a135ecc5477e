"""Device ms per traced serving tick of the HiFi-GAN generator: the
``stage_begin_vocoder`` marker (the conditioning and conv_pre, and again
conv_post) and ``stage_begin_vocoder_s1`` ... ``_s4`` (each upsampling
stage: its transposed conv and its resblocks), to the next marker each.
Nothing when the trace holds no marker; 0 where the step ran no
generator."""

from benchmark import stages

STAGES = ("vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3", "vocoder_s4")


def read(rec):
    return stages.stage_ms(rec, STAGES)
