"""The port's BoostMVSNeRF fine-tuning step against the benchmark's plain
reference of it (``portbench/reference/boost_mvsnerf_train.py``) on the
CPU at 64x96: 4 source views, K=2, 2 targets of 64 random rays, 8 samples,
seeded weights, 2 steps of the recipe's loss, clip and Adam. The faults the
reference plants read outside the bars the port keeps; the cell's flow
(``portbench/flows/ray_train_steps.py``) runs end to end through
``portbench/run.run_cell`` and is correct; the step's counted work
(``portbench/harness/mvsnerf_step.py``, read by ``mfu.mvsnerf_step``)
equals a count by hand. Torch runs at one intra-op thread."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
from boostmvsnerfs_torch.train.schedule import make_optimizer
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch
from portbench import run
from portbench.harness import mvsnerf_step, roofline
from portbench.harness.weights import seeded_state_dict
from portbench.reference import boost_mvsnerf_train as reference
from portbench.tests.portbench_support import ROOT, config_file, manifest, traffic

CELL = "mvsnerf_free_finetune"
SEED = 2**31 + 91
STEPS = 2
# the first loss, relative; each leaf's first gradient, against the leaf's
# largest; each leaf's change over the steps, by norm, against the reference's
LOSS_RTOL = 1e-5
GRAD_BAR = 1e-4
UPDATE_BAR = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config() -> dict:
    """The cell's configuration file at the test's size: 64x96, K=2, a
    batch of 2 targets of 64 rays."""
    config = config_file("boost_mvsnerf_free_finetune")
    ft = config["finetune"]
    ft["train"]["batch_size"] = 2
    ft["enerf"]["cas_config"].update(num_rays=[64], k_best=2)
    return config


def _batch(seed: int) -> dict:
    """Two targets over 4 source views, combinations 0 and 3 of C(4, 3),
    each target with 64 random rays and their colours."""
    rays = make_scene_batch(B=2, n_views=4, H=64, W=96, boost=True, seed=seed, rig="forward",
                            render_scales=(1.0,), with_targets=True, ray_subsample={0: 64})
    return {**mvsnerf_batch(rays, k_best=(0, 3)), "ray_idx_0": rays["ray_idx_0"]}


@pytest.fixture(scope="module")
def steps():
    """(tree, weights, batches, the port's losses, first gradients and
    parameters after the steps, the reference's)."""
    torch.set_num_threads(1)
    tree = small_config()["finetune"]
    model = runner.make_network(tree, "cpu")
    weights = seeded_state_dict(model.state_dict(), SEED, torch.device("cpu"))
    model.load_state_dict(weights)
    state = create_train_state(model, make_optimizer(tree["train"], 1000))
    step = make_train_step(model, cas=CascadeConfig.from_cfg(tree["enerf"]))
    batches = [_batch(s) for s in range(STEPS)]
    losses, first = [], None
    for b in batches:
        losses.append(float(step(state, b)["loss"]))
        if first is None:
            opt = state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            first = {n: opt.state[p]["exp_avg"] / (1 - beta1)
                     for n, p in model.named_parameters() if p in opt.state}
    port = {"losses": losses, "first_grads": first,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    ref = reference.train_steps(tree, weights, batches, torch.device("cpu"))
    return tree, weights, batches, port, ref


def _grad_gaps(got: dict, want: dict) -> dict:
    """Each leaf's largest gradient gap over the leaf's largest gradient."""
    return {n: float((got[n] - g).abs().max() / max(float(g.abs().max()), 1e-30))
            for n, g in want.items()}


def test_the_first_loss_and_gradients_equal_the_reference(steps):
    _, _, _, port, ref = steps
    assert port["losses"][0] == pytest.approx(ref["losses"][0], rel=LOSS_RTOL)
    assert port["first_grads"].keys() == ref["first_grads"].keys()
    gaps = _grad_gaps(port["first_grads"], ref["first_grads"])
    assert max(gaps.values()) <= GRAD_BAR, sorted(gaps.items(), key=lambda kv: -kv[1])[:5]


def test_the_parameters_after_the_steps_equal_the_reference(steps):
    """Each leaf's change over 2 Adam steps of lr 5e-5 within 1e-3 of the
    reference's change, by norm (2e-4 read at the worst leaf: Adam divides
    an element's gradient by its own size, so an element near nought keeps
    the gradient's rounding as a share of lr); every leaf moved."""
    tree, weights, _, port, ref = steps
    lr = float(tree["train"]["lr"])
    for n, p in ref["params"].items():
        want = p - weights[n]
        assert float((port["params"][n] - p).norm()) <= UPDATE_BAR * float(want.norm()), n
        assert float(want.abs().max()) > 0.5 * lr, n
    assert port["losses"][1] == pytest.approx(ref["losses"][1], rel=LOSS_RTOL)


@pytest.mark.parametrize("fault", reference.FAULTS)
def test_a_planted_fault_reads_outside_the_bars(steps, fault):
    tree, weights, batches, _, ref = steps
    bad = reference.train_steps(tree, weights, batches, torch.device("cpu"), fault)
    loss_gap = abs(bad["losses"][0] - ref["losses"][0]) / ref["losses"][0]
    grad_gap = max(_grad_gaps(bad["first_grads"], ref["first_grads"]).values())
    assert loss_gap > 100 * LOSS_RTOL and grad_gap > 100 * GRAD_BAR, (loss_gap, grad_gap)


def _run_cell(**traffic_kw) -> dict:
    tr = traffic("free_mvsnerf_finetune", 16, batches=2, **traffic_kw)
    result, _ = run.run_cell(manifest(), CELL, SEED, 1e-9, False, torch.device("cpu"),
                             small_config(), tr)
    return result


def test_the_cell_runs_end_to_end_and_is_correct():
    result = _run_cell()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"first_loss_rel_gap", "grad_leaf_gap", "update_median_gap"}
    assert result["attempted"] >= 1 and {"step_ms", "setup_s"} <= set(result["metrics"])


@pytest.fixture(scope="module")
def small_flow():
    """The cell's flow at the test's size, one checked step taken."""
    from portbench.harness import drive

    tr = traffic("free_mvsnerf_finetune", 16, batches=1, checked_steps=1)
    flow = drive.make_flow(drive.Context(small_config(), tr, SEED, torch.device("cpu")))
    flow.free_program()
    yield flow
    flow.close()


def test_the_flow_holds_its_batches_as_the_step_takes_them(small_flow):
    """Each cycled batch holds tensors of the types the step's copy casts to
    (floats float32, the rest int64), so the copy to the card casts nothing
    on the host; their values are the loader's."""
    (batch,) = small_flow.batches
    held = {k: v for k, v in batch.items() if k != "meta"}
    assert held and all(torch.is_tensor(v) for v in held.values())
    assert {k for k, v in held.items() if v.dtype == torch.float32} == {
        k for k, v in held.items() if v.is_floating_point()}
    assert all(v.dtype == torch.int64 for v in held.values() if not v.is_floating_point())
    assert batch["msk_0"].dtype == torch.int64 and bool(batch["msk_0"].bool().any())
    targets, n_views, rays = small_flow.draws[0]
    assert [m["tar_view"] for m in batch["meta"]] == targets
    assert batch["all_src_inps"].shape[1] == n_views
    np.testing.assert_array_equal(batch["ray_idx_0"].numpy(), rays)


@pytest.mark.parametrize("fault", reference.FAULTS)
def test_a_planted_fault_is_not_correct_by_the_cells_limits(small_flow, fault):
    """The harness's own comparison: each fault the reference plants, put in
    the program's place, fails the cell's limits, and fails the gradient's
    alone (the backward pass is held by ``grad_leaf_gap``)."""
    from portbench.harness import check

    limits = check.limits_of(CELL)
    values = small_flow.readings(fault)
    assert not check.judge(values, limits)[0], values
    assert values["grad_leaf_gap"] > limits["grad_leaf_gap"], values


def test_the_cell_with_its_update_left_out_is_not_correct(monkeypatch):
    """The optimizer's update left out of the port's step: the parameters
    never move, and the check reads it."""
    from boostmvsnerfs_torch.parallel import train

    monkeypatch.setattr(train, "apply_update", lambda optimizer, scheduler: None)
    result = _run_cell()
    assert not result["correct"] and result["checks"]["update_median_gap"][0] > 0.5


def test_the_reference_and_flow_import_neither_jax_nor_the_port():
    code = ("import portbench.reference.boost_mvsnerf_train, portbench.flows.ray_train_steps\n"
            "import portbench.harness.mvsnerf_step\n"
            "import sys, json\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    found = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not found & {"jax", "jaxlib", "flax", "optax", "boostmvsnerfs_tpu",
                        "boostmvsnerfs_torch"}


def _conv2d(hw, cin, cout, k):
    return 2 * hw * cin * cout * k * k


def _conv3d(voxels, cin, cout):
    return 2 * voxels * cin * cout * 27


def test_the_step_work_equals_a_count_by_hand():
    """One target over 3 views at 32x32, K=1, pad 0, 8 planes, 2 rays: the
    feature net's 9 layers over 3 images, the warp of 2 views (20 + 8 * 35
    operations a voxel and view), the U-Net's 10 layers (a transposed one
    over its input voxels), the lookups, and
    the MLP's 10 layers (125,696 multiply-adds a sample with 20 features and
    a 63-wide encoding, plus 2 * 3 * 10 operations of the encoding)."""
    H = W = 32
    costs = mvsnerf_step.step_costs(H, W, 1, 3, 1, 3, 8, 0, 128, 6, 10, 2)
    features = 3 * (_conv2d(1024, 3, 8, 3) + _conv2d(1024, 8, 8, 3) + _conv2d(256, 8, 16, 5)
                    + 2 * _conv2d(256, 16, 16, 3) + _conv2d(64, 16, 32, 5)
                    + 2 * _conv2d(64, 32, 32, 3) + _conv2d(64, 32, 32, 1))
    voxels = 8 * 8 * 8  # D x (H/4 + 2 pad) x (W/4 + 2 pad)
    warp = 2 * voxels * (20 + 8 * 35)
    unet = (_conv3d(voxels, 41, 8)  # conv0
            + _conv3d(64, 8, 16) + _conv3d(64, 16, 16)  # conv1 (stride 2), conv2: 4x4x4
            + _conv3d(8, 16, 32) + _conv3d(8, 32, 32)  # conv3, conv4: 2x2x2
            + _conv3d(1, 32, 64) + _conv3d(1, 64, 64)  # conv5, conv6: 1x1x1
            + _conv3d(1, 64, 32) + _conv3d(8, 32, 16) + _conv3d(64, 16, 8))  # conv7, 9, 11
    samples = 2 * 8
    macs = (63 * 128 + 4 * 128 * 128 + (128 + 63) * 128  # pts_0..5, the skip into pts_5
            + 20 * 128 + 128 + 128 * 128  # pts_bias, alpha, feature
            + (128 + 3) * 64 + 64 * 3)  # views_0, rgb
    assert macs == 125_696
    mlp = samples * (2 * macs + 2 * 3 * 10)
    tri = samples * (8 * (2 + 2 * 8) + 12)
    img = 3 * samples * (20 + 7 * 3)
    want = {"features": features, "warp": warp, "costreg": unet, "tri_sample": tri,
            "img_sample": img, "mlp": mlp}
    assert {k: c.flops for k, c in costs.items() if k != "total"} == want
    assert costs["total"].flops == sum(want.values()) and costs["total"].tc_flops == 0


def test_the_step_work_of_the_recipe():
    """The recipe's step (4 targets over 3 views at 480x736, K=4, 1,024 rays
    of 8 samples): three times the forward's operations, and the forward's
    volumes and samples as the eval frame's stages count them."""
    tree = config_file("boost_mvsnerf_free_finetune", (480, 736))["finetune"]
    costs = mvsnerf_step.step_costs(480, 736, 4, 3, 4, 3, 8, 24, 128, 6, 10, 1024)
    frame = roofline.mvsnerf_render_costs(480, 736, 16, 3, 8, 24, 128, 6, 12, 10)
    for stage in ("features", "warp"):
        assert costs[stage].flops == frame[stage].flops
    assert costs["costreg"].flops == 16 * mvsnerf_step.unet_flops(8, 168, 232)
    assert costs["mlp"].flops * 480 * 736 == pytest.approx(
        1024 * (frame["mlp"].flops + frame["mlp"].tc_flops))
    assert mvsnerf_step.step_flops(tree) == 3 * costs["total"].flops
    assert np.isclose(mvsnerf_step.step_flops(tree), 584_651_636_736.0)
