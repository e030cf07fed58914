"""``mfu.mvsnerf_step``: the MVSNeRF fine-tuning step's counted operations
(``harness/mvsnerf_step.step_flops``: three times the forward's) at the
card's float32 peak over the step's time on the device (the span of the
traced steps' device records, from the first operation's start to the last
one's end, per step), in %."""

from portbench.harness import mvsnerf_step, roofline


def read(run):
    p = run.profile
    if not p or p["span_s"] <= 0.0:
        return None
    return mvsnerf_step.step_flops(run.cfg) / roofline.peaks(run.card).f32_flops / p["span_s"] * 100.0
