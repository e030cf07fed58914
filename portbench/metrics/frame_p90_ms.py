"""``frame_p90_ms``: the 90th percentile of every frame's latency in the
window (host clock from the frame's start to a card sync), in ms; only
where at least 100 frames were completed, so that ten lie beyond it."""

import numpy as np

MIN_FRAMES = 100


def read(run):
    if len(run.latencies) < MIN_FRAMES:
        return None
    return float(np.percentile(run.latencies, 90)) * 1e3
