"""``renderer_mlp_roofline``: the renderer MLP stage's least time on the
card (the frozen ``harness/roofline`` frame costs, stage ``mlp``) over the
device time per frame of the kernels named in ``KERNELS``, in %."""

from portbench.harness import roofline

KERNELS = ("renderer_mlp_kernel",)
STAGE = "mlp"


def read(run):
    p = run.profile
    if not p:
        return None
    device_s = sum(t for name, t in p["kernels_s"].items() if any(k in name for k in KERNELS))
    if device_s <= 0.0:
        return None
    H, W = run.cfg["test_dataset"]["input_h_w"]
    costs = roofline.frame_costs(run.cfg, H, W)
    return costs[STAGE].bound(roofline.peaks(run.card))[0] / 1e3 / device_s * 100.0
