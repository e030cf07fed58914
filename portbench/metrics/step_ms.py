"""``step_ms``: the window's length over the whole fine-tuning steps
completed in it (each step's stats brought to the host), in ms."""


def read(run):
    return run.window_s / len(run.latencies) * 1e3 if run.latencies else None
