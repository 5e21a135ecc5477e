"""Device ms per traced serving tick of the BigVGAN generator: the
``stage_begin_vocoder`` marker (the conditioning, conv_pre and its bias,
and again activation_post's conv_post and clamp) and
``stage_begin_vocoder_s1`` ... ``_s6`` (each upsampling stage: its
transposed conv, its AMP blocks and their activations), to the next
marker each.  Nothing when the trace holds no marker; 0 where the step ran
no generator."""

from benchmark import stages

STAGES = ("vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3", "vocoder_s4",
          "vocoder_s5", "vocoder_s6")


def read(rec):
    return stages.stage_ms(rec, STAGES)
