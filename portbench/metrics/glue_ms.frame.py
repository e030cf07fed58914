"""``glue_ms.frame``: device ms per frame of the plain PyTorch glue in the
traced sub-window: device busy less the networks (convolutions and batch
norm) less the port's hand-written kernels (by kernel name)."""


def read(run):
    p = run.profile
    return p["glue_s"] * 1e3 if p else None
