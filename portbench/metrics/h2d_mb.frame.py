"""``h2d_mb.frame``: MB (1e6 bytes) a frame that cross from host memory to
the card over the traced sub-window, each profile taken included: the
counter ``h2d_bytes`` (``models/enerf.to_tensors``, after the cast) over
the calls of ``executor.frame`` in the same table
(``utils/profiling.traced``). Nothing to read from a program without
them."""


def read(run):
    if run.profile is None:
        return None
    try:
        from boostmvsnerfs_torch.utils.profiling import traced
    except ImportError:
        return None
    table = traced()
    frames = table["spans"].get("executor.frame", {}).get("n", 0)
    if not frames or "h2d_bytes" not in table["counters"]:
        return None
    return table["counters"]["h2d_bytes"] / 1e6 / frames
