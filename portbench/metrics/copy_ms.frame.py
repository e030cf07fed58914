"""``copy_ms.frame``: host ms per frame in the span ``eval.to_card`` (the
batch to the card, ``runner._device_batch``) over the traced sub-window,
each profile taken included: the span's host time over the calls of
``executor.frame`` in the same table (``utils/profiling.traced``). Nothing
to read from a program without the spans."""


def read(run):
    if run.profile is None:
        return None
    try:
        from boostmvsnerfs_torch.utils.profiling import traced
    except ImportError:
        return None
    spans = traced()["spans"]
    frames = spans.get("executor.frame", {}).get("n", 0)
    if not frames or "eval.to_card" not in spans:
        return None
    return spans["eval.to_card"]["host_s"] / frames * 1e3
