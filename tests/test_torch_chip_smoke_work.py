"""chip_smoke.py's checks rehearsed on the CPU: work counts and bounds on
toy inputs, the phases' launch designs, and the card-vs-CPU bars against
float32's own spread and the planted faults.

The sampler's bound charges the map bytes that the four bilinear taps can
touch, not the whole map: a ray block of the fine-tuning step samples a band
of each map, and a bound that charged the whole map would be slower than
F.grid_sample's measured time on the same inputs. The renderer MLP's bound
charges its dense layers to the tensor cores at bf16 (989 TFLOP/s) and to
the f32 units at f32 (67 TFLOP/s).
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(x, y, V=2, H=9, W=13, C=5):
    imgs = torch.zeros(V, H, W, C)
    t = lambda a: torch.tensor(np.broadcast_to(np.asarray(a, np.float32), (V, len(a))).copy())  # noqa: E731
    return imgs, t(x), t(y)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_samples_inside_one_pixel_touch_its_four_taps(smoke, padding_mode):
    rng = np.random.default_rng(0)
    imgs, x, y = _case(rng.uniform(4.05, 4.95, 50), rng.uniform(2.05, 2.95, 50))
    V, _, _, C = imgs.shape
    assert smoke.touched_pixels(imgs, x, y, padding_mode) == 4 * V
    n = x.numel()
    nbytes, _ = smoke.sample_work(imgs, x, y, padding_mode)
    assert nbytes == 4 * (4 * V * C + 2 * n + n * C)
    nbytes, _ = smoke.sample_bwd_work(imgs, x, y, torch.zeros(V, x.shape[1], C), padding_mode)
    assert nbytes == 4 * (4 * V * C + imgs.numel() + 4 * n + n * C)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_samples_covering_the_map_touch_all_of_it(smoke, padding_mode):
    V, H, W, C = 2, 9, 13, 5
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    # every pixel centre, plus samples far outside (behind the camera, and
    # past the zeros padding's clamp), which add no pixel
    x = np.concatenate([xx.ravel(), [1e10, -1e10, W + 5.0]])
    y = np.concatenate([yy.ravel(), [-1e10, 1e10, H + 5.0]])
    imgs, x, y = _case(x, y, V, H, W, C)
    assert smoke.touched_pixels(imgs, x, y, padding_mode) == V * H * W
    n = x.numel()
    assert smoke.sample_work(imgs, x, y, padding_mode)[0] == 4 * (imgs.numel() + 2 * n + n * C)


@pytest.mark.parametrize("compute_dtype,want_ms", [(torch.bfloat16, 2.565), (torch.float32, 37.87)])
def test_mlp_bound_at_the_main_paths_sample_count(smoke, compute_dtype, want_ms):
    """The MVSNeRF main path's MLP work (4 x 78,848 rays x 32 samples, F =
    20, the encoded instance): the published-width MLP's weights on toy
    (meta) input tensors of the path's sample count."""
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig, RendererMLP

    params = RendererMLP(MVSNeRFConfig(), 20).mlp_params()
    n = 224 * 352 * 32
    pts, feat, dirs = (torch.empty(4, n, w, device="meta") for w in (63, 20, 3))
    ms, by = smoke.bound(*smoke.mlp_work(params, pts, feat, dirs, 0, compute_dtype))
    assert by == "operations"
    assert round(ms, 3 if compute_dtype == torch.bfloat16 else 2) == want_ms


def test_eval_entry_launch_design(smoke):
    """The eval entry's launches: each target view's pre-pass in
    ceil(combinations / k_best) chunks (BoostENeRF: the warp at both
    levels, no sampler or head), then its frame."""
    per = {"warp_variance": 2, "img_sample": 1, "enerf_head": 1}
    chunk = {"warp_variance": 2}
    assert smoke.expected_eval_launches(2, 20, 4, chunk, per) == {
        "warp_variance": 24, "img_sample": 2, "enerf_head": 2}
    assert smoke.expected_eval_launches(3, 4, 3, chunk, per) == {
        "warp_variance": 18, "img_sample": 3, "enerf_head": 3}
    mvs = {"tri_sample": 1, "img_sample": 1, "renderer_mlp": 1}
    assert smoke.expected_eval_launches(2, 20, 4, {}, mvs) == dict.fromkeys(mvs, 2)


def test_greedy_steps_follow_search_k_best(smoke):
    from boostmvsnerfs_torch.models.boost_enerf import greedy_steps, search_k_best

    masks = np.random.default_rng(0).uniform(size=(20, 12, 16)).astype(np.float32) ** 4
    picks, margins = greedy_steps(masks, 4)
    assert picks == search_k_best(masks, 4) and len(margins) == 4
    assert all(m > 0 for m in margins)
    masks[3] = masks[7]  # an exact tie: the lowest id wins, with a zero margin
    picks, margins = greedy_steps(masks, 20)
    assert picks.index(3) < picks.index(7) and margins[picks.index(3)] == 0.0
    rep = smoke.compare_masks(masks, masks, 4)
    assert rep["mask_max_abs_diff"] == 0.0 and rep["picks"] == rep["ref_picks"]
    assert smoke.masks_within_limits(rep)


def test_compare_picks_stops_at_a_near_tie(smoke):
    """Steps are compared while their margin exceeds 2 (t + 1) e, e the
    largest mean difference of one combination's masks, where no
    difference can reorder them."""
    H, W = 8, 8
    masks = np.zeros((3, H, W), np.float32)
    masks[0, :, :6] = 1.0  # covers 0.75
    masks[1, :, 4:] = 0.5
    masks[2, :, 4:] = 0.5 + 1e-3  # beats combination 1 by a hair
    ref = masks.copy()
    ref[2] -= 2e-3  # e = 2e-3: step 1's margin is ample, step 2's is not
    rep = smoke.compare_masks(masks, ref, 2)
    assert rep["picks"] == [0, 2] and rep["ref_picks"] == [0, 1]
    assert rep["steps_compared"] == 1
    assert rep["mask_mean_abs_diff"] == pytest.approx(2e-3, rel=1e-5)
    assert not smoke.masks_within_limits(rep)  # every pixel of combination 2 moved
    rep = smoke.compare_masks(masks, masks + 1e-7, 2)  # margins far above 6e-7
    assert rep["steps_compared"] == 2 and rep["picks"] == rep["ref_picks"] == [0, 2]
    assert smoke.masks_within_limits(rep)


def test_mask_limits_count_a_few_pixels_against_the_mean(smoke):
    """A large difference at a few pixels (a sample crossing a viewport
    edge) passes; the same difference spread over a share of pixels
    above MASK_PIXEL_SHARE_TOL fails."""
    ref = np.full((4, 100, 100), 0.5, np.float32)
    masks = ref.copy()
    masks[1, 0, :2] += 0.05
    assert smoke.masks_within_limits(smoke.compare_masks(masks, ref, 2))
    masks[1, :1, :] += 2e-3
    rep = smoke.compare_masks(masks, ref, 2)
    assert rep["mask_pixel_share"] == pytest.approx(1e-2)
    assert not smoke.masks_within_limits(rep)


@pytest.mark.parametrize("family", ["boost_enerf", "boost_mvsnerf"])
def test_mask_faults_fail_the_limits(smoke, tmp_path, family):
    """The eval check's controls (MASK_FAULTS) on the CPU port over a small
    scene of the eval phases' rig: each moves the coverage masks past the
    limits, and leaves the port unpatched after the block."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader
    from boostmvsnerfs_torch.models.boost_enerf import view_combinations
    from boostmvsnerfs_torch.ops import render
    from boostmvsnerfs_torch.ops.cuda import warp_variance
    from boostmvsnerfs_torch.utils.synthetic import write_free_scene, write_scannet_scene

    ws = str(tmp_path)
    if family == "boost_enerf":
        write_free_scene(f"{ws}/Free", "grass", rig="varied")
        cfg_file, scene = smoke.FREE_EVAL, "grass"
        fault = "warp_variance: the first view's features lost"
    else:
        write_scannet_scene(f"{ws}/scannet_plus", "scene0000_01", n=8, H=64, W=96, rig="varied")
        cfg_file, scene = smoke.SCANNET_EVAL, "scene0000_01"
        fault = "viewport_visibility: the first view sees nothing"
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cfg = smoke.eval_cfg(cfg_file, ws, scene, "test_dataset.input_h_w", "[64, 96]")
    finally:
        os.chdir(cwd)
    model = runner.make_network(cfg, "cpu")
    runner._init_or_load(cfg, model)
    batch = next(iter(Loader(make_dataset(cfg, "test"), 1)))
    arrays = {k: v for k, v in batch.items() if k != "meta"}
    combos = view_combinations(arrays["all_src_inps"].shape[1], 3)
    k = int(cfg.enerf.cas_config.k_best)
    originals = (warp_variance.warp_variance_plain, render.viewport_visibility)
    sound = model.forward_view_selection(arrays, combos).numpy()[:, 0]
    with smoke.planted(fault, smoke.MASK_FAULTS):
        faulty = model.forward_view_selection(arrays, combos).numpy()[:, 0]
    assert (warp_variance.warp_variance_plain, render.viewport_visibility) == originals
    assert smoke.masks_within_limits(smoke.compare_masks(sound, sound, k))
    assert not smoke.masks_within_limits(smoke.compare_masks(faulty, sound, k))


@pytest.fixture
def one_thread():
    """torch's intra-op threads at 1 for a test: with several test processes
    sharing a machine's few cores, their pools' spinning threads slow each
    other down many times over, while these small tensors gain little from
    more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted(monkeypatch, one_thread):
    """On the CPU every kernel wrapper takes its plain version; count those
    calls as the wrappers count their launches on the card, so that
    ``launch_counts`` reads what a card run would launch. The models import
    first: a module that imports a plain version by name (the train-mode
    head) keeps the original, which launches nothing on the card. The
    convolutions' weight gradients take their route on the CPU too, as on
    the card (``models/blocks.WGRAD_DEVICES``), and so do the 3D
    convolutions' data gradients (``DGRAD_DEVICES``)."""
    import boostmvsnerfs_torch.runner  # noqa: F401
    from boostmvsnerfs_torch.models import blocks
    from boostmvsnerfs_torch.ops.cuda import (
        _build,
        conv_dgrad,
        conv_wgrad,
        enerf_head,
        img_sample,
        renderer_mlp,
        tri_sample,
        warp_variance,
    )

    monkeypatch.setattr(blocks, "WGRAD_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(blocks, "DGRAD_DEVICES", ("cuda", "cpu"))
    for module, attr, name in ((conv_wgrad, "conv_wgrad_plain", "conv_wgrad"),
                               (conv_dgrad, "conv_dgrad_plain", "conv_dgrad"),
                               (warp_variance, "warp_variance_plain", "warp_variance"),
                               (warp_variance, "warp_variance_bwd_plain", "warp_variance_bwd"),
                               (img_sample, "row_sample_plain", "img_sample"),
                               (img_sample, "row_sample_bwd_plain", "img_sample_bwd"),
                               (enerf_head, "nerf_head_plain", "enerf_head"),
                               (tri_sample, "tri_sample_plain", "tri_sample"),
                               (renderer_mlp, "renderer_mlp_plain", "renderer_mlp")):
        fn = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a, fn=fn, name=name, **kw: (
            _build.count_launch(name), fn(*a, **kw))[1])
    _build.reset_launch_counts()


def _in_repo(fn, *args):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def test_visualize_and_path_launch_designs(smoke, tmp_path, counted):
    """The phases ``visualize`` and ``path`` on a Free scene at 64x96: the
    launches of ``run.py --type visualize`` (the pre-pass, then a frame per
    test view) and of ``render_novel_path`` (per frame the pre-pass's 5
    chunks and the frame) equal the designs the phases check."""
    from boostmvsnerfs_torch import run as trun
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    ws = str(tmp_path)
    smoke.free_scene(ws, 64, 96)
    cfg = _in_repo(smoke.eval_cfg, smoke.FREE_EVAL, ws, "grass", "test_dataset.input_h_w",
                   "[64, 96]", "write_video", "false")
    smoke.save_seeded_weights(cfg)
    out = trun.run_visualize(cfg, "cpu")
    assert out["frames"] == 2 and out["writer"] == "png"
    assert launch_counts() == smoke.added(smoke.prepass_design(2, 20, 4),
                                          smoke.scaled(smoke.ENERF_FRAME, 2))
    reset_launch_counts()
    out = runner.render_novel_path(cfg, n_frames=2, device="cpu")
    per_frame = smoke.added(smoke.prepass_design(1, 20, 4), smoke.ENERF_FRAME)
    assert per_frame == dict(smoke.NO_LAUNCHES, warp_variance=12, img_sample=1, enerf_head=1,
                             conv_dgrad=30)
    assert launch_counts() == smoke.scaled(per_frame, 2)
    assert len(out["per_frame"]) == 2 and all(len(f["k_best"]) == 4 for f in out["per_frame"])


def test_train_entry_design_and_resume(smoke, tmp_path, counted):
    """``drive_train_entry`` over the fine-tuning recipe at 64x96 on the
    CPU, one step an epoch (batch 1) in 2 ray blocks: the first run's and
    the resumed run's launches, steps, validation and pre-pass pass the
    phase's checks against ``train_entry_design``; the resumed run begins
    at epoch 1. The per-step design does not depend on the batch size:
    the folded batch goes through each kernel in one launch."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.models.enerf import CascadeConfig

    ws = str(tmp_path)
    smoke.free_scene(ws, 64, 96)
    opts = ("train_dataset.input_h_w", "[64, 96]", "test_dataset.input_h_w", "[64, 96]",
            "ep_iter", "1", "train.batch_size", "1", "save_result", "false")
    cfg = _in_repo(smoke.train_entry_cfg, ws, *opts)
    smoke.save_pretrain(cfg)
    first = smoke.drive_train_entry(cfg, 2, "cpu")
    resumed = smoke.drive_train_entry(_in_repo(smoke.train_entry_cfg, ws, *opts, "train.epoch",
                                               "2"), 2, "cpu")
    model = runner.make_network(cfg, "cpu")
    batch = smoke.first_train_batch(cfg, runner.load_view_selection(cfg), "cpu")
    assert tuple(batch["all_src_inps"].shape[:2]) == (1, 3)  # 3 views: one combination
    design = smoke.train_entry_design(model, batch, 2, steps=1)
    assert design["step"] == dict(smoke.NO_LAUNCHES, warp_variance=2, warp_variance_bwd=2,
                                  img_sample=5, img_sample_bwd=3, conv_wgrad=32, conv_dgrad=21)
    assert design["prepass"] == dict(smoke.NO_LAUNCHES, warp_variance=2 * 14 + 2 * 5 * 2,
                                     conv_dgrad=5 * 14 + 5 * 5 * 2)
    smoke.check_train_entry_run("first", first, design, 0, steps=1)
    smoke.check_train_entry_run("resumed", resumed, design, 1, steps=1)
    assert (first["final_step"], resumed["final_step"]) == (1, 2)
    unblocked = smoke.expected_train_launches(BoostENeRFLike(CascadeConfig(k_best=4)), batch, 0)
    assert unblocked == dict(smoke.NO_LAUNCHES, warp_variance=2, warp_variance_bwd=2,
                             img_sample=2, img_sample_bwd=2)


class BoostENeRFLike:
    """The loss settings of a BoostENeRF, and no convolutions."""

    def __init__(self, cas):
        self.cas = cas

    def modules(self):
        return iter(())


def _train_run(batches, dtype, steps_snaps, model=None, cas=None):
    """Two steps of ``train_epochs`` (BoostENeRF K=2 unless ``model`` is
    given, with the loss settings ``cas``; lr 5e-5) from seeded weights, at
    ``dtype``: (losses, the parameters before, and after each step)."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.runner import train_epochs
    from boostmvsnerfs_torch.utils.port_weights import random_state_dict

    if model is None:
        model = BoostENeRF(CascadeConfig(k_best=2, volume_planes=(16, 8)), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(model, 0).items()})
    model.to(dtype)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, snaps = [], []

    def on_record(kind, state, r):
        losses.append(r["loss"])
        snaps.append({k: p.detach().clone() for k, p in state.model.named_parameters()})

    train_epochs(model, batches, {"lr": 5e-5, "epoch": 1}, steps_snaps, log_interval=1,
                 on_record=on_record, device="cpu", cas=cas)
    return losses, start, snaps


def test_train_bars_pass_float32_and_fail_a_skipped_step(smoke, tmp_path, record_property,
                                                          one_thread):
    """The card-vs-CPU bars of the training entry on the CPU port at 64x96:
    float32 against float64 (the same two steps, weights and batches)
    passes them; float32 against float64 with its last Adam step skipped,
    the smoke run's control, fails them."""
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    batches = [make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, k_best=2, seed=s,
                                rig="orbit", with_targets=True) for s in (0, 1)]
    l32, start32, s32 = _train_run(batches, torch.float32, str(tmp_path / "f32"))
    l64, start64, s64 = _train_run(batches, torch.float64, str(tmp_path / "f64"))
    d32 = smoke.param_delta(s32[-1], start32)
    reading = smoke.train_readings(l32, l64, d32, smoke.param_delta(s64[-1], start64))
    control = smoke.train_readings(l32, l64, d32, smoke.param_delta(s64[-2], start64))
    record_property("float32_vs_float64", reading)
    record_property("control_last_step_skipped", control)
    assert smoke.within_train_bars(reading), reading
    assert not smoke.within_train_bars(control), control


def test_chip_smoke_train_phases_rehearse_on_cpu(smoke, monkeypatch):
    """chip_smoke.py's training pieces at 32x64 on the CPU: the backward
    kernels' inputs from the model's train-mode stages (each wrapper takes
    its plain version here), their work counts, the launches per blocked
    step the code implies (16 blocks: the same counts as at 480x736), the
    step's weight gradients that the card routes to ``conv_wgrad`` (routed
    here too, through its plain version), the smooth card-vs-CPU batch and
    the gradient comparison."""
    from boostmvsnerfs_torch.models import blocks
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.ops.cuda.img_sample import row_sample_bwd
    from boostmvsnerfs_torch.ops.cuda.warp_variance import fused_warp_variance, warp_variance_bwd
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    model = BoostENeRF(CascadeConfig(k_best=2), device="cpu")
    model.load_state_dict(smoke.random_weights(model, 0), strict=True)
    batch = to_tensors(make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True, k_best=2,
                                        rig="forward", with_targets=True), torch.device("cpu"))
    with torch.no_grad():
        inputs = smoke.train_kernel_inputs(model, batch)
        (l0, (f0, _, d0, g0)), (l1, (f1, _, d1, g1)) = inputs["warp_variance_bwd"]
        assert (l0, l1) == ("level0", "level1")
        # the training forward (#1's f32 instance) on the same inputs
        assert [(label, a[0], a[2], a[3]) for label, a in inputs["warp_variance"]] == [
            (l0, f0, d0, torch.float32), (l1, f1, d1, torch.float32)]
        assert f0.shape == (2, 3, 8, 16, 32) and d0.shape == (2, 64, 4, 8)
        assert g0.shape == (2, 64, 4, 8, 32) and g1.shape == (2, 8, 16, 32, 16)
        (s0, (i0, x0, _, c0)), (s1, (i1, x1, _, c1)) = inputs["img_sample_bwd"]
        assert (s0, s1) == ("level0", "level1 block 1 of 16")
        assert i0.shape == (6, 8, 16, 35) and x0.shape == (6, 8 * 16 * 8)
        assert i1.shape == (6, 32, 64, 11) and x1.shape == (6, 2 * 64 * 2)
        assert c1.shape == (6, 2 * 64 * 2, 11)
        for name, wrapper in (("warp_variance_bwd", warp_variance_bwd),
                              ("img_sample_bwd", row_sample_bwd)):
            for _, args in inputs[name]:
                assert all(torch.isfinite(o).all() for o in wrapper(*args)), name
                assert min(smoke.TRAIN_KERNELS[name][3](*args)) > 0, name
        for _, args in inputs["warp_variance"]:
            assert torch.isfinite(fused_warp_variance(*args)).all()
            assert min(smoke.TRAIN_KERNELS["warp_variance"][3](*args)) > 0
        assert [label for label, _ in inputs["img_sample"]] == [s0, s1]
        for (_, fwd), (_, bwd) in zip(inputs["img_sample"], inputs["img_sample_bwd"]):
            assert all(a is b for a, b in zip(fwd, bwd[:3]))
            assert min(smoke.TRAIN_KERNELS["img_sample"][3](*fwd)) > 0
    assert smoke.expected_train_launches(model, batch) == dict(
        smoke.NO_LAUNCHES, warp_variance=2, warp_variance_bwd=2, img_sample=33,
        img_sample_bwd=17, conv_wgrad=32, conv_dgrad=21)
    monkeypatch.setattr(blocks, "WGRAD_DEVICES", ("cuda", "cpu"))
    records = smoke.routed_conv_records(model, batch)
    assert len(records) == smoke.routed_convs(model) == 32
    assert records[0]["weight"] == [1, 8, 3, 3, 3] and records[-1]["weight"] == [8, 3, 3, 3]
    assert {r["x_layout"] for r in records} == {"channels_last"}
    assert all(p.grad is None for p in model.parameters())
    smooth = smoke.smooth_scene_batch(32, 64, seed=3)
    assert smooth["src_inps"].shape == (1, 4, 32, 64, 3)
    assert np.abs(smooth["src_inps"]).max() <= 1.5
    state = smoke.random_weights(model, 0)
    for dtype, kind in ((torch.float32, "blocked"), (torch.float64, "plain")):
        loss, grads = smoke.train_step_grads(state, smooth, "cpu", dtype, kind)
        assert np.isfinite(loss) and grads.keys() == dict(model.named_parameters()).keys()
        assert all(g.dtype == torch.float64 and torch.isfinite(g).all() for g in grads.values())
    g = {"a": torch.ones(3), "b": torch.zeros(2)}
    assert smoke.grad_rel_errors(g, g) == {"a": 0.0, "b": 0.0}
    assert smoke.global_rel_error(g, {"a": torch.ones(3), "b": torch.ones(2)}) == pytest.approx(
        np.sqrt(2 / 5))


def test_chip_smoke_gradient_bars_separate_float32_from_planted_faults(smoke):
    """chip_smoke.py's card-vs-CPU gradient bars at their own size (128x192,
    4 views, K=2) on the CPU port against float64: float32's own steps (on
    the batch and on ulp-perturbed copies) pass them, and each planted
    wiring fault fails them; every planted function is restored after."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig

    originals = {f: getattr(importlib.import_module(f"boostmvsnerfs_torch.ops.{m}"), a)
                 for f, (m, a, _) in smoke.PLANTED_FAULTS.items()}
    state = smoke.random_weights(BoostENeRF(CascadeConfig(k_best=2), device="cpu"), 0)
    batch = smoke.smooth_scene_batch(128, 192, seed=3)
    _, ref = smoke.train_step_grads(state, batch, "cpu", torch.float64, "plain")
    f32 = [smoke.train_step_grads(state, batch, "cpu", torch.float32, k)[1]
           for k in ("plain", "blocked")]
    bars = smoke.cpu_bar_readings(state, batch, ref, f32)
    assert len(bars["spread"]) == 2 + smoke.ULP_PERTURBATIONS
    assert all(smoke.within_bars(r) for r in bars["spread"]), bars["spread"]
    assert bars["faults"].keys() == smoke.PLANTED_FAULTS.keys()
    for fault, r in bars["faults"].items():
        assert not smoke.within_bars(r), (fault, r)
    for f, (m, a, _) in smoke.PLANTED_FAULTS.items():
        assert getattr(importlib.import_module(f"boostmvsnerfs_torch.ops.{m}"), a) is originals[f]


# ------------------------------------- the MVSNeRF heads and MVSNeRF training


def test_mvsnerf_heads_check_the_lookups_only(smoke):
    """``mvs_kernel_inputs`` of a head whose MLP runs plainly holds the
    lookups (#6, #3) and no renderer-MLP entry; a v0 model's holds all."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.enerf import to_tensors
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch

    batch = to_tensors(mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True,
                                                      seed=0, rig="forward",
                                                      render_scales=(1.0,)), k_best=(0, 3)),
                       torch.device("cpu"))
    for net_type, want in (("v1", {"tri_sample", "tri_sample/f32", "img_sample"}),
                           ("v0", set(smoke.MVS_KERNELS))):
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8, net_type=net_type),
                             device="cpu")
        with torch.no_grad():
            assert set(smoke.mvs_kernel_inputs(model, batch)) == want, net_type
    assert set(smoke.MVS_HEADS) | {"v0", "attention"} == set(
        __import__("boostmvsnerfs_torch.models.mvsnerf", fromlist=["NET_TYPES"]).NET_TYPES)


def test_mvsnerf_train_entry_design_and_resume(smoke, tmp_path, counted):
    """``drive_train_entry`` over the BoostMVSNeRF fine-tuning recipe at
    32x64 on the CPU, one step an epoch (batch 4, 1024 random rays): the
    launches of both runs, of each step (the colour lookup only), of the
    pre-pass (none) and of the validation (#6, #3, #8 per frame) pass the
    phase's checks against ``mvs_entry_design``; the step's colour-lookup
    inputs are the recipe's."""
    from boostmvsnerfs_torch import runner

    ws = str(tmp_path)
    smoke.free_scene(ws, 32, 64)
    opts = ("train_dataset.input_h_w", "[32, 64]", "test_dataset.input_h_w", "[32, 64]",
            "ep_iter", "1", "save_result", "false")
    cfg = _in_repo(smoke.mvs_entry_cfg, ws, *opts)
    weights = smoke.save_pretrain(cfg)
    first = smoke.drive_train_entry(cfg, 0, "cpu")
    resumed = smoke.drive_train_entry(_in_repo(smoke.mvs_entry_cfg, ws, *opts, "train.epoch",
                                               "2"), 0, "cpu")
    design = smoke.mvs_entry_design(cfg, steps=1)
    assert design["first"] == dict(smoke.NO_LAUNCHES, img_sample=3, tri_sample=2,
                                   renderer_mlp=2, conv_wgrad=19, conv_dgrad=10 + 2 * 3)
    smoke.check_train_entry_run("first", first, design, 0, steps=1)
    smoke.check_train_entry_run("resumed", resumed, design, 1, steps=1)
    assert (first["final_step"], resumed["final_step"]) == (1, 2)
    batch = smoke.first_train_batch(cfg, runner.load_view_selection(cfg), "cpu")
    (label, (imgs, x, y, mode)), = smoke.mvs_step_inputs(cfg, weights, batch, "cpu")["img_sample"]
    assert imgs.shape == (4 * 4 * 3, 32, 64, 3) and x.shape == (48, 1024 * 8) and mode == "border"


@pytest.fixture
def eight_threads():
    """torch's intra-op threads at 8, the card machine's cores: one thread
    sums each BatchNorm's statistics and each convolution's weight gradient
    over the volume's voxels in one float32 sequence, whose rounding alone
    moves the BoostMVSNeRF step's gradients past the bars (0.06 together at
    64x96), and at 4 threads the second step's loss lay 5.5e-4 from
    float64's; the partial sums of 8 threads, like the card's reduction
    trees, stay near float64."""
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(n)


def test_mvsnerf_step_bars_pass_float32_and_fail_the_faults(smoke, record_property,
                                                             eight_threads):
    """The BoostMVSNeRF step's gradient bars on the CPU port at 64x96:
    float32 against float64 (and 4 copies of the batch moved by ~1 ulp)
    passes them; each fault of MVS_FAULTS fails them."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig

    state = smoke.random_weights(BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8),
                                              device="cpu"), 0)
    batch = smoke.mvs_step_batch(64, 96, seed=3)
    steps = {}
    for dtype in (torch.float32, torch.float64):
        steps[dtype] = _in_repo(smoke.mvs_step_grads, state, batch, "cpu", dtype)
    np.testing.assert_allclose(steps[torch.float32][0], steps[torch.float64][0], rtol=1e-5)
    bars = _in_repo(smoke.cpu_bar_readings, state, batch, steps[torch.float64][1],
                    [steps[torch.float32][1]], lambda b: _in_repo(
                        smoke.mvs_step_grads, state, b, "cpu", torch.float32)[1],
                    smoke.MVS_FAULTS)
    record_property("bars", bars)
    assert all(smoke.within_bars(r, smoke.MVS_GRAD_BARS) for r in bars["spread"]), bars
    assert len(bars["faults"]) == 3
    for fault, r in bars["faults"].items():
        assert not smoke.within_bars(r, smoke.MVS_GRAD_BARS), (fault, r)


def test_mvsnerf_train_bars_pass_float32_and_fail_a_skipped_step(smoke, tmp_path,
                                                                  record_property, eight_threads):
    """The training entry's card-vs-CPU bars (``train_check``) on the CPU
    port's BoostMVSNeRF (K=2, the recipe's loss settings) at 64x96 over two
    random-ray batches: float32 against float64 passes them, and with the
    last Adam step skipped fails them."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig

    cas = _in_repo(smoke.mvs_recipe_cas)
    batches = [smoke.mvs_step_batch(64, 96, seed=s) for s in (0, 1)]
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8), device="cpu")
        runs[dtype] = _train_run(batches, dtype, str(tmp_path / str(dtype)), model, cas)
    (l32, start32, s32), (l64, start64, s64) = runs[torch.float32], runs[torch.float64]
    d32 = smoke.param_delta(s32[-1], start32)
    reading = smoke.train_readings(l32, l64, d32, smoke.param_delta(s64[-1], start64))
    control = smoke.train_readings(l32, l64, d32, smoke.param_delta(s64[-2], start64))
    record_property("float32_vs_float64", reading)
    record_property("control_last_step_skipped", control)
    assert smoke.within_train_bars(reading), reading
    assert not smoke.within_train_bars(control), control


def test_composite_frame_and_step_launch_designs(smoke, counted):
    """The phases ``composite`` and ``composite_train`` at their check size
    (128x192, 64x64 crops) on the CPU: a frame of the composite from YAML
    launches COMPOSITE_FRAME, 2 of its heads without voxel features; the
    kernel inputs come from the first layer's crop (the image-feature-only
    head at C = 11 and 35); a train step launches #1 and #2 per volume, #3
    and #4 per rendered layer and level, no head."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.models.enerf import to_tensors
    from boostmvsnerfs_torch.models.variants import CompositeENeRF
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = _in_repo(smoke.composite_cfg, "composite.fg_hw", "[64, 64]")
    model = runner.make_network(cfg, "cpu")
    assert (model.num_fg_layers, model.bg.cas.volume_planes) == (2, (16, 4))
    batch = to_tensors(smoke.composite_batch(*smoke.COMPOSITE_CHECK_HW,
                                             smoke.COMPOSITE_CHECK_ORIGINS, 0), model.device)
    with torch.no_grad():
        model(batch)
        assert launch_counts() == smoke.added(smoke.COMPOSITE_FRAME)
        assert smoke.no_vox_heads_per_frame(model, batch) == smoke.COMPOSITE_NO_VOX_HEADS
        inputs = smoke.composite_kernel_inputs(model, batch)
    assert inputs.keys() == smoke.COMPOSITE_KERNELS.keys()
    assert [a[0].shape[-1] for _, a in inputs["warp_variance"]] == [32, 16]
    assert tuple(inputs["img_sample"][0][1][1].shape) == (3, 64 * 64 * 2)
    for C in (11, 35):
        (_, (params, vox, feat, _)), = inputs[f"enerf_head/no_vox_C{C}"]
        assert vox is None and feat.shape[-1] == C and params["lr0"][0].shape[1] == 16
    reset_launch_counts()
    step_model = CompositeENeRF(model.cas, num_fg_layers=2, fg_hw=smoke.COMPOSITE_CHECK_FG,
                                device="cpu")
    state = smoke.random_weights(step_model, 0)
    step_batch = smoke.composite_batch(64, 96, ((16, 0), (32, 0)), seed=3, targets=True)
    loss, grads = smoke.composite_step_grads(state, step_batch, "cpu", torch.float32)
    assert np.isfinite(loss) and grads.keys() == state.keys() - {
        k for k in state if "running" in k or "num_batches" in k}
    assert smoke.routed_convs(step_model) == 72  # 76 with the foreground's unread heads
    # 12 transposed convolutions; the input gradients of the 6 U-Nets' 7
    # others, less the foreground's 4 unread heads (no backward)
    assert smoke.routed_dgrads(step_model) == 12 + 6 * 7 - 4
    assert launch_counts() == smoke.added({"warp_variance": 6, "warp_variance_bwd": 6,
                                           "img_sample": 6, "img_sample_bwd": 6,
                                           "conv_wgrad": 72, "conv_dgrad": 50})


def test_staged_mvsnerf_phase_rehearses_on_cpu(smoke, tmp_path, counted):
    """The phase ``staged_mvsnerf`` on a Free scene at 64x96 on the CPU (8
    samples a ray): the eval entry's launches (no pre-pass launch; 2 test
    views, each frame in 2 row blocks of 32 rows) pass the phase's design;
    the staged frame equals the monolithic one; the kernels' inputs are one
    block's; the v1 head's staged frame equals its monolithic frame at
    32x64 (one block) and renders at 64x96."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.parallel.staged import ray_blocks

    ws = str(tmp_path)
    smoke.free_scene(ws, 64, 96)
    opts = ("enerf.cas_config.num_samples", "[8]")
    cfg = _in_repo(smoke.eval_cfg, smoke.MVS_FREE_EVAL, ws, "grass", "test_dataset.input_h_w",
                   "[64, 96]", "eval_lpips", "false", *opts)
    smoke.save_seeded_weights(cfg)
    _, launches = _in_repo(smoke.staged_entry, cfg, "cpu")
    assert launches == dict(smoke.NO_LAUNCHES, tri_sample=4, img_sample=4, renderer_mlp=4,
                            conv_dgrad=2 * 3)
    model = runner.make_network(cfg, "cpu")
    runner._init_or_load(cfg, model)
    vs = runner.load_view_selection(cfg)
    batch = smoke.first_test_batch(cfg, vs, "cpu")
    rec = smoke.staged_frames(model, batch, "rehearsal")
    assert rec["row_blocks"] == 2 and set(rec["max_abs_err"].values()) == {0.0}
    ids = ray_blocks(batch["ray_idx_0"], 96, smoke.MVS_ROW_CHUNK)
    inputs = smoke.mvs_kernel_inputs(model, batch, ids[0])
    (_, (imgs, x, y, mode)), = inputs["img_sample"]
    (_, (vol, xyz, spr)), = inputs["tri_sample"]
    assert x.shape == (4 * 3, 32 * 96 * 8) and xyz.shape == (4, 32 * 96 * 8, 3) and spr == 8
    v1 = _in_repo(smoke.staged_v1_frames, ws, vs, ((32, 64), (64, 96)), "cpu", *opts)
    assert set(v1["32x64"]["max_abs_err"].values()) == {0.0}
    assert v1["64x96"]["row_blocks"] == 2 and "monolithic" not in v1["64x96"]
