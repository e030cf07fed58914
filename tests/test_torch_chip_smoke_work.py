"""chip_smoke.py's work counts and bounds on toy inputs (CPU).

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


class _Event:
    def __init__(self, name, device, corr):
        self._name, self._device, self._corr = name, device, corr

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr


class _Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("R", (), {
            "events": staticmethod(lambda: events)})})


def test_lost_launches_leave_out_the_primer(smoke):
    """A complete profile's check pairs each kernel launch after the
    primer's with its device record by correlation id: the primer's lost
    records do not count, the block's do."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    n = smoke.PRIMER_KERNELS
    events = [_Event("cudaLaunchKernel", cpu, c) for c in range(1, n + 4)]
    events += [_Event("aten::mul", cpu, 0), _Event("cudaStreamSynchronize", cpu, n + 9)]
    events += [_Event("spin_kernel(long)", cuda, c) for c in range(3, n + 1)]  # 2 lost
    events += [_Event("k", cuda, c) for c in (n + 1, n + 2, n + 3)]
    assert smoke.lost_launches(_Profile(events)) == 0
    events.pop()  # the block's last record
    events.append(_Event("cuLaunchKernel", cpu, n + 5))
    assert smoke.lost_launches(_Profile(events)) == 2
