"""``issue_ms.step``: host ms per call of the span ``train.step``
(``parallel/train._update``: the batch to the card, forward, backward and
update issued; the caller's read of the stats lies outside it) over the
traced sub-window, each profile taken included
(``utils/profiling.traced``). Nothing to read from a program without the
span."""


def read(run):
    if run.profile is None:
        return None
    try:
        from boostmvsnerfs_torch.utils.profiling import traced
    except ImportError:
        return None
    step = traced()["spans"].get("train.step")
    if not step or not step["n"]:
        return None
    return step["host_s"] / step["n"] * 1e3
