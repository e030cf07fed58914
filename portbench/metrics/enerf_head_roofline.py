"""``enerf_head_roofline``: the ENeRF head stage's least time on the card
(the frozen ``harness/roofline`` frame costs of the rendered levels'
``nerf`` stages) over the device time per frame of the kernels named in
``KERNELS``, in %."""

from portbench.harness import roofline

KERNELS = ("enerf_head_kernel",)
STAGE_PREFIX = "nerf"


def read(run):
    p = run.profile
    if not p:
        return None
    device_s = sum(t for name, t in p["kernels_s"].items() if any(k in name for k in KERNELS))
    if device_s <= 0.0:
        return None
    H, W = run.cfg["test_dataset"]["input_h_w"]
    card = roofline.peaks(run.card)
    costs = roofline.frame_costs(run.cfg, H, W)
    bound_ms = sum(c.bound(card)[0] for k, c in costs.items() if k.startswith(STAGE_PREFIX))
    return bound_ms / 1e3 / device_s * 100.0
