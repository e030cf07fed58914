"""``issue_ms.frame``: host ms per call of the span ``executor.frame`` (the
frame executor's issue of a frame; the caller's card sync lies outside it)
over the traced sub-window, each profile taken included
(``utils/profiling.traced``). Nothing to read from a program without the
span."""


def read(run):
    if run.profile is None:
        return None
    try:
        from boostmvsnerfs_torch.utils.profiling import traced
    except ImportError:
        return None
    frame = traced()["spans"].get("executor.frame")
    if not frame or not frame["n"]:
        return None
    return frame["host_s"] / frame["n"] * 1e3
