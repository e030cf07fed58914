"""``conv_ms.frame``: device ms per frame under ``aten::convolution`` and
``aten::batch_norm`` (cuDNN's networks) in the traced sub-window."""


def read(run):
    p = run.profile
    return (p["conv_s"] + p["norm_s"]) * 1e3 if p else None
