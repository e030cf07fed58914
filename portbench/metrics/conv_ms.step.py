"""``conv_ms.step``: device ms per fine-tuning step under cuDNN's
convolutions and batch norm, forward and backward (``aten::convolution``,
``aten::convolution_backward``, ``aten::batch_norm`` and its backward), in
the traced sub-window."""


def read(run):
    p = run.profile
    return (p["conv_s"] + p["norm_s"]) * 1e3 if p else None
