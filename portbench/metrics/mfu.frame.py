"""``mfu.frame``: the frame's counted operations at the card's peaks (the
frozen ``harness/roofline.frame_costs`` at the cell's shapes) over the
frame's time on the device: the span of the traced frames' device records,
from the first operation's start to the last one's end, per frame; in %."""

from portbench.harness import roofline


def read(run):
    p = run.profile
    if not p or p["span_s"] <= 0.0:
        return None
    H, W = run.cfg["test_dataset"]["input_h_w"]
    total = roofline.frame_costs(run.cfg, H, W)["total"]
    return roofline.frame_speed_of_light(total, p["span_s"], roofline.peaks(run.card))["mfu"] * 100.0
