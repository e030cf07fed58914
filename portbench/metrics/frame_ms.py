"""``frame_ms``: the window's length over the frames completed in it (the
window ends at a frame's end), in ms."""


def read(run):
    return run.window_s / len(run.latencies) * 1e3 if run.latencies else None
