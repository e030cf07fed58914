"""The frozen yardstick: the frame costs at the cells' shapes, the scene
generator, the seeded weights and the profile's interval arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import profile, roofline, scene
from portbench.harness.weights import seeded_state_dict
from portbench.tests.portbench_support import config_file


@pytest.mark.parametrize("config, bound_ms", [("boost_enerf_free", 2.44),
                                              ("boost_mvsnerf_free", 14.51)])
def test_frame_bound_at_the_cells_shapes(config, bound_ms):
    """The frozen frame costs give the bounds that PERF.md quotes: the
    BoostENeRF eval frame 2.44 ms, the staged MVSNeRF frame 14.51 ms."""
    cfg = config_file(config, (480, 736))["cfg"]
    ms, by = roofline.frame_costs(cfg, 480, 736)["total"].bound(roofline.H100)
    assert round(ms, 2) == bound_ms and by == "operations"


@pytest.mark.parametrize("config", ["boost_enerf_free", "boost_mvsnerf_free"])
def test_frame_costs_equal_the_ports_stage_by_stage(config):
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.utils import roofline as port

    cfg = config_file(config, (480, 736))["cfg"]
    mine = roofline.frame_costs(cfg, 480, 736)
    if config == "boost_enerf_free":
        theirs = port.flagship_render_costs(480, 736, cas=CascadeConfig.from_cfg(cfg["enerf"]))
    else:
        theirs = port.mvsnerf_render_costs(480, 736)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert (mine[k].flops, mine[k].bytes, mine[k].tc_flops) == \
            (theirs[k].flops, theirs[k].bytes, theirs[k].tc_flops), k


def test_mfu_of_a_frame():
    costs = roofline.Roofline(flops=67e9, bytes=1.0, tc_flops=0.0)
    assert roofline.frame_speed_of_light(costs, 0.1)["mfu"] == pytest.approx(0.01)


def test_scene_reads_as_a_free_scene(tmp_path):
    """48 images on the walk: the port's Free dataset finds 6 test views
    (every 8th), each with 6 source views, its images smooth and seeded."""
    from boostmvsnerfs_torch.data.free import FreeDataset
    from boostmvsnerfs_torch.models.enerf import CascadeConfig

    scene.write_free_scene(str(tmp_path / "Free"), "walk", 48, 32, 48, seed=2**31 + 5)
    ds = FreeDataset(str(tmp_path / "Free"), "test", CascadeConfig(), input_h_w=(32, 48),
                     scenes=["walk"], n_test_views=6)
    assert [m[1] for m in ds.metas] == [0, 8, 16, 24, 32, 40]
    sample = ds.get_sample(1)
    assert sample["src_inps"].shape == (6, 32, 48, 3)
    assert np.abs(np.diff(sample["src_inps"], axis=2)).mean() < 0.05  # smooth
    again = tmp_path / "again"
    scene.write_free_scene(str(again), "walk", 48, 32, 48, seed=2**31 + 5)
    assert (tmp_path / "Free/walk/images_2/0007.jpg").read_bytes() == \
        (again / "walk/images_2/0007.jpg").read_bytes()


def test_seeded_weights():
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF

    template = BoostENeRF(device="cpu").state_dict()
    a = seeded_state_dict(template, 2**31 + 99, torch.device("cpu"))
    b = seeded_state_dict(template, 2**31 + 99, torch.device("cpu"))
    c = seeded_state_dict(template, 2**31 + 100, torch.device("cpu"))
    assert a.keys() == template.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cost_reg_1.conv0.conv.weight"], c["cost_reg_1.conv0.conv.weight"])
    w = a["cost_reg_1.conv0.conv.weight"]
    assert w.std().item() == pytest.approx(1 / np.sqrt(np.prod(w.shape[1:])), rel=0.1)
    var = a["cost_reg_1.conv0.bn.running_var"]
    assert 0.5 <= var.min().item() and var.max().item() <= 1.5


def test_busy_is_the_union_of_device_intervals():
    merged = profile._merged([(0, 10, "a"), (5, 12, "b"), (20, 25, "c")])
    assert [(a, b) for a, b, _ in merged] == [(0, 12), (20, 25)]


def test_pick_step_gap_reads_nought_on_greedy_picks_only():
    from portbench.harness.check import pick_step_gap
    from portbench.reference.plain.boost_enerf import greedy_steps

    rng = np.random.default_rng(0)
    masks = (rng.uniform(0, 1, (20, 8, 8)) * (rng.uniform(size=(20, 1, 1)) > 0.3)).astype(np.float32)
    picks, _ = greedy_steps(masks, 4)
    assert pick_step_gap(masks, picks, 4) == 0.0
    assert pick_step_gap(masks, picks[:2] + picks[1:2] * 2, 4) > 0.01  # stopped early
    assert pick_step_gap(masks, [19, 18, 17, 16], 4) > 0.01
    tie = masks.copy()
    tie[5] = tie[picks[0]]  # an exact tie with the first pick: either is a greedy outcome
    assert pick_step_gap(tie, [5] + picks[1:], 4) == 0.0
