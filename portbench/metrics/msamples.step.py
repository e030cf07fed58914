"""``msamples.step``: the samples the MVSNeRF render makes per training step
(the counter ``render.samples``, B*K*R*D a render, read from
``utils/profiling.traced``) per call of the span ``train.step``, over the
traced sub-window, in millions. Nothing to read from a program without the
counter."""


def read(run):
    if run.profile is None:
        return None
    try:
        from boostmvsnerfs_torch.utils.profiling import traced
    except ImportError:
        return None
    table = traced()
    step = table["spans"].get("train.step")
    samples = table["counters"].get("render.samples")
    if not step or not step["n"] or samples is None:
        return None
    return samples / step["n"] / 1e6
