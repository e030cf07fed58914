"""Each traffic mix driven at a small size on the CPU through the harness's
own functions (``run.py`` refuses the CPU: these skip its look for a card),
and the check seeing ``correct`` come out false under each fault the cells
can have, planted in the timed path.

On the CPU the port's kernels take their float32 plain versions, so the
reference runs its kernels in float32 too (``kernel_precision``): a sound
run reads nought to rounding, and a fault must read beyond the cell's
limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import drive
from portbench.reference.plain.kernels import kernel_precision
from portbench.tests.portbench_support import cell_files, manifest

torch.set_num_threads(4)
SEED = 2**31 + 77


def _run(cell: str, seconds: float = 0.0) -> dict:
    cfg, tr = cell_files(cell)
    with kernel_precision(torch.float32):
        result, _ = run.run_cell(manifest(), cell, SEED, seconds, False, torch.device("cpu"),
                                 cfg, tr)
    return result


@pytest.mark.parametrize("cell", ["enerf_free_eval", "mvsnerf_free_eval"])
def test_a_cell_at_a_small_size_is_correct(cell):
    result = _run(cell, seconds=1e-9)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"frame_ms", "setup_s"} <= set(result["metrics"])
    assert list(result)[-1] == "checks"


def test_test_views_cycle_every_view_in_a_seeded_order():
    cfg, tr = cell_files("enerf_free_eval")
    flow = drive.make_flow(drive.Context(cfg, tr, SEED, torch.device("cpu")))
    try:
        n = len(flow.batches)
        order = [flow.next_key() for _ in range(2 * n)]
        assert sorted(order[:n]) == sorted(order[n:]) == list(range(n))
    finally:
        flow.close()


def _altered(fwd, change):
    def wrapped(batch):
        out = dict(fwd(batch))
        for k in [k for k in out if k.startswith(("rgb_", "depth_"))]:
            out[k] = change(out[k])
        return out
    return wrapped


def _half(t):
    t = t.clone()
    t[:, t.shape[1] // 2:] = 0.0
    return t


FAULTS = {
    # an answer altered where it is produced: the frame 2% darker
    "answer_altered": lambda t: t * 0.98,
    # half of the batch left out: the second half of the frame's rays never rendered
    "rays_left_out": _half,
}


@pytest.mark.parametrize("cell, fault", [("enerf_free_eval", "answer_altered"),
                                         ("enerf_free_eval", "rays_left_out"),
                                         ("mvsnerf_free_eval", "answer_altered")])
def test_a_broken_frame_is_not_correct(monkeypatch, cell, fault):
    from boostmvsnerfs_torch import runner

    make_forward = runner.make_forward
    monkeypatch.setattr(runner, "make_forward",
                        lambda cfg, model: _altered(make_forward(cfg, model), FAULTS[fault]))
    assert not _run(cell, seconds=1e-9)["correct"]


@pytest.mark.parametrize("cell", ["enerf_free_eval"])
def test_altered_picks_are_not_correct(monkeypatch, cell):
    """The view selection's answer altered where it is produced: the
    combinations that cover the least instead of the most."""
    from boostmvsnerfs_torch import runner

    def worst(model, batch, combos, k):
        masks = model.forward_view_selection(batch, combos).cpu().numpy()
        cover = masks.reshape(masks.shape[0], masks.shape[1], -1).mean(-1)  # (n, B)
        return np.argsort(cover, axis=0)[:k].T.astype(np.int32)

    monkeypatch.setattr(runner, "greedy_select", worst)
    assert not _run(cell, seconds=1e-9)["correct"]


def _half_batch(step):
    def wrapped(state, batch):
        n = batch["all_src_inps"].shape[0] // 2
        return step(state, {k: v if k == "combos" else v[:n] for k, v in batch.items()})
    return wrapped


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
def test_finetune_steps_against_the_reference(monkeypatch, fault):
    """The fine-tuning cell: a run whose first steps go through the port's
    step reads nought to rounding against the reference's steps and is
    correct; under each fault planted in the step underneath (the
    optimizer's update left out, half of the batch left out, the rendered
    colour altered where it is made) a run is not correct, and the fault
    reads far beyond."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.parallel import train

    if fault == "state_unchanged":
        monkeypatch.setattr(train, "apply_update", lambda optimizer, scheduler: None)
    elif fault == "half_batch":
        make = train.make_blocked_train_step
        monkeypatch.setattr(train, "make_blocked_train_step",
                            lambda *a, **k: _half_batch(make(*a, **k)))
    elif fault == "answer_altered":
        blend = BoostENeRF.blend
        monkeypatch.setattr(BoostENeRF, "blend",
                            lambda self, raw, B: {**blend(self, raw, B),
                                                  "rgb": blend(self, raw, B)["rgb"] * 0.98})
    result = _run("enerf_free_finetune", seconds=1e-9)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1 and {"step_ms", "setup_s"} <= set(result["metrics"])
    cfg, tr = cell_files("enerf_free_finetune")
    flow = drive.make_flow(drive.Context(cfg, tr, SEED, torch.device("cpu")))
    try:
        flow.free_program()
        r = flow.readings()
    finally:
        flow.close()
    worst = max(r["first_loss_rel_gap"], r["loss_rel_gap"], r["grad_leaf_gap"],
                r["update_median_gap"])
    if fault is None:
        assert r["loss_rel_gap"] < 1e-5 and r["grad_leaf_gap"] < 1e-4, r
        assert r["update_median_gap"] < 1e-3, r
    else:
        assert worst > 1e-2, r
    assert r["first_loss_rel_gap"] <= r["loss_rel_gap"]
