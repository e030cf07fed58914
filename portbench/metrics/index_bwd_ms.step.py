"""``index_bwd_ms.step``: device ms per step in PyTorch's advanced-indexing
backward (kernels named ``indexing_backward_kernel*``) in the traced steps:
the scatters that undo the plain gathers of the MVSNeRF step, its plane-sweep
warp's (two views, features and colours, four taps each) and its trilinear
lookup's."""

NAME = "indexing_backward_kernel"


def read(run):
    p = run.profile
    if not p:
        return None
    return sum(s for name, s in p["kernels_s"].items() if NAME in name) * 1e3
