"""The learned stages' share (%) of the card's bf16 peak over the traced
ticks: their FLOPs for the live lanes (``formulas.serve_learned_flops``
per lane and tick, from the configuration's shapes) over the ticks' wall
time."""

from benchmark import formulas


def read(rec):
    if rec is None or not rec.device or "learned_flops_lane" not in rec.info:
        return None
    flops = rec.info["learned_flops_lane"] * rec.counters.get(
        "lane_steps_live", 0)
    if flops <= 0:
        return None
    return 100.0 * flops / rec.window_s() / formulas.PEAK_BF16_FLOPS
