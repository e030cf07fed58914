"""``idle_pct.frame``: the share of the traced sub-window in which no
operation ran on the device, in %."""


def read(run):
    p = run.profile
    return (1.0 - p["busy_total_s"] / p["window_s"]) * 100.0 if p else None
