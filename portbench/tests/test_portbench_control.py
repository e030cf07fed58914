"""The control on the card: the plain reference computed with TF32 (one
step below the configurations' float32) in the program's place must come
out not correct, where the program's own frames come out correct. At each
cell's own size, on one seed each (``portbench/calibrate.py`` reads a dozen).

Run on the card: ``python -m pytest -m cuda portbench/tests/test_portbench_control.py``."""

from __future__ import annotations

import json
import os

import pytest

from portbench.tests.portbench_support import BENCH, ROOT, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import boostmvsnerfs_torch

    from portbench import run
    from portbench.harness import check, drive

    boostmvsnerfs_torch.set_numerics()
    _, config, traffic = run.cell_of(manifest(), cell)
    with open(os.path.join(ROOT, config["file"])) as f:
        ctx = drive.Context(json.load(f), traffic, 2**31 + 4242, torch.device("cuda", 0))
    flow = drive.make_flow(ctx)
    try:
        for _ in range(int(traffic.get("checked_frames", 0))):
            flow.unit()
        flow.free_program()
        limits = check.limits_of(cell)
        program_ok, shown = check.judge(flow.readings(), limits)
        control_ok, control = check.judge(flow.readings("control"), limits)
    finally:
        flow.close()
    assert program_ok, shown
    assert not control_ok, control
    assert os.path.exists(os.path.join(BENCH, "limits", f"{cell}.json"))
