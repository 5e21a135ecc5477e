"""The training step's share (%) of the card's float32 peak (the precision
the configuration trains in, TF32 off) over the traced steps: three times
the forward FLOPs of the learned stacks the joint objective trains
(``formulas.train_forward_flops`` at the batch's shapes) per step, over
the steps' wall time."""

from benchmark import formulas


def read(rec):
    if (rec is None or not rec.device or not rec.steps
            or "learned_flops_step" not in rec.info):
        return None
    flops = rec.info["learned_flops_step"] * rec.steps
    return 100.0 * flops / rec.window_s() / formulas.PEAK_F32_FLOPS
