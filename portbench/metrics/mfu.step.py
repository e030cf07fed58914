"""``mfu.step``: the fine-tuning step's counted operations at the card's
float32 peak over the step's time on the device (the span of the traced
step's device records, from the first operation's start to the last one's
end), in %: three times the frozen forward work
(``harness/roofline.flagship_render_costs``) of the step's shapes (both
levels rendered on full images, a batch of ``train.batch_size`` targets of
``train_input_views[1]`` views), the usual forward + backward convention
with the ray blocks' recomputation not counted; every operation of the
training step runs in float32."""

from portbench.harness import roofline


def read(run):
    p = run.profile
    if not p or p["span_s"] <= 0.0:
        return None
    cfg = run.cfg
    en, cas = cfg["enerf"], cfg["enerf"]["cas_config"]
    H, W = cfg["train_dataset"]["input_h_w"]
    total = roofline.flagship_render_costs(
        H, W, en["train_input_views"][1], cas["k_best"], en["cost_volume_input_views"],
        cas["volume_planes"], cas["volume_scale"], cas["render_if"], cas["num_samples"])["total"]
    flops = 3 * cfg["train"]["batch_size"] * (total.flops + total.tc_flops)
    return flops / roofline.peaks(run.card).f32_flops / p["span_s"] * 100.0
