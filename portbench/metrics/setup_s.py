"""``setup_s``: from the process's start to the window's start, in s:
imports, the scene and weights made from the seed, the kernels' build or
load, the model, the view-selection pre-pass and the warm-up."""


def read(run):
    return run.setup_s
