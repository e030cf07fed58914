"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips without a CUDA device. The file imports
torch and the port only, so it also runs on a GPU machine without JAX,
where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the warp and sampler kernels round their coordinates in the
plain versions' order (every tap the same) and their tap sums in that
order or with FMAs, so they agree to a few ulps (rtol 1e-5 / atol 1e-6).
The head, the renderer MLP, the warp and the volume sampler at bf16 (the
head's one contract, the others' default) are held against their plain
versions at bf16: the products are exact in f32 on both sides, but the
head's and the MLP's sums run in another order, and a sum that straddles
a bf16 rounding boundary moves the next layer's operand by one bf16 ulp;
so 1e-2 of the output's largest magnitude (at least 1), chip_smoke.py's
bar, and their mean error against the f32 plain version at most 1.5
times the bf16 plain version's own. The MLP's f32 kernel sums up to
191-term dot products through six layers in another order than cuBLAS,
and is held at 1e-4 of its output's largest magnitude. The two backward
kernels scatter their feature and image cotangents with atomics, whose
order changes from run to run, and reduce the depth and coordinate
cotangents in another order than the plain versions: each output is held
at 1e-4 of its largest magnitude (chip_smoke.py's bar).
"""

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.models.enerf import ENeRF, CascadeConfig, to_tensors
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig, RendererMLP
from boostmvsnerfs_torch.models.nerf_head import NeRFHead
from boostmvsnerfs_torch.ops import cost_volume, geometry
from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts
from boostmvsnerfs_torch.ops.cuda.enerf_head import fused_nerf_head, nerf_head_plain
from boostmvsnerfs_torch.ops.cuda.img_sample import (
    fused_row_sample,
    fused_row_sample_diff,
    row_sample_bwd,
    row_sample_bwd_plain,
    row_sample_plain,
)
from boostmvsnerfs_torch.ops.cuda.renderer_mlp import fused_renderer_mlp, renderer_mlp_plain
from boostmvsnerfs_torch.ops.cuda.tri_sample import fused_tri_sample, tri_sample_plain
from boostmvsnerfs_torch.ops.cuda.warp_variance import (
    fused_warp_variance,
    fused_warp_variance_diff,
    warp_variance_bwd,
    warp_variance_bwd_plain,
    sweep_tile,
    warp_variance_plain,
)
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    return torch.device("cuda")


def _close(got, want, rtol, atol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rig,C", [("orbit", 8), ("forward", 16), ("orbit", 32)])
def test_warp_variance_kernel(dev, rig, C, compute_dtype):
    B, S, Hs, Ws, Ht, Wt, D = 2, 3, 40, 56, 20, 28, 7
    b = make_scene_batch(B=B, n_views=S, H=Hs, W=Ws, seed=C, rig=rig)
    t = {k: torch.from_numpy(v).to(dev) for k, v in b.items() if k != "src_inps"}
    pm = geometry.proj_mats(t["src_ixts"], t["src_exts"], t["tar_ixt"], t["tar_ext"],
                            1.0, Ht / Hs).contiguous()
    rng = np.random.default_rng(C)
    feats = torch.from_numpy(rng.standard_normal((B, S, Hs, Ws, C)).astype(np.float32)).to(dev)
    dv = torch.from_numpy(rng.uniform(0.2, 8.0, (B, D, Ht, Wt)).astype(np.float32)).to(dev)
    got = fused_warp_variance(feats, pm, dv, compute_dtype)
    want = warp_variance_plain(feats, pm, dv, compute_dtype)
    if compute_dtype == torch.float32:
        _close(got, want, 1e-5, 1e-6)
    else:
        _close_bf16(got, want, warp_variance_plain(feats, pm, dv))
    assert launch_counts()["warp_variance"] == 1


def test_warp_variance_kernel_default_is_bf16(dev):
    """The wrapper's default compute dtype is bf16, as in JAX (and the
    eval path's ``warp_dtype``): the same output bit for bit."""
    feats, pm, dv, _ = _warp_case(dev, "forward", 16, 3)
    a = fused_warp_variance(feats, pm, dv)
    b = fused_warp_variance(feats, pm, dv, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert launch_counts()["warp_variance"] == 2


# Sampler cases: every channel count of the model paths (3, 11, 35) and
# others around the kernels' tiles (1, 8, 32); P leaves a ragged last tile,
# and at P = 37 one tile spans every view. The first samples sit on the frame's
# edges, on integers, at the zeros padding's clamp bounds and behind the
# camera (~1e10 px).
SAMPLE_WIDTHS = (1, 3, 8, 11, 32, 35)
SAMPLE_COUNTS = (37, 5001)


def _sample_case(dev, seed, C, P, V=6, H=30, W=44):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.standard_normal((V, H, W, C)).astype(np.float32)).to(dev)
    x = rng.uniform(-4, W + 3, (V, P)).astype(np.float32)
    y = rng.uniform(-4, H + 3, (V, P)).astype(np.float32)
    x[:, :8] = [0.0, W - 1, 1e10, 3.0, 7.5, -2.0, W + 1, -1e10]
    y[:, :8] = [H - 1, 0.0, -1e10, 2.0, 4.0, H + 1, -2.0, 1e10]
    g = torch.from_numpy(rng.standard_normal((V, P, C)).astype(np.float32)).to(dev)
    return imgs, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), g


@pytest.mark.parametrize("P", SAMPLE_COUNTS)
@pytest.mark.parametrize("C", SAMPLE_WIDTHS)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_img_sample_kernel(dev, padding_mode, C, P):
    imgs, x, y, _ = _sample_case(dev, 1, C, P)
    _close(fused_row_sample(imgs, x, y, padding_mode), row_sample_plain(imgs, x, y, padding_mode),
           1e-5, 1e-6)
    assert launch_counts()["img_sample"] == 1


BF16_RTOL, BF16_MEAN_RATIO = 1e-2, 1.5


def _close_bf16(got, want, want_f32):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= BF16_RTOL * max(1.0, float(want.abs().max())), err
    mean, own = float((got - want_f32).abs().mean()), float((want - want_f32).abs().mean())
    assert mean <= BF16_MEAN_RATIO * own, (mean, own)


@pytest.mark.parametrize("S", [2, 3, 4, 8])
@pytest.mark.parametrize("C,viewdir_agg", [(11, True), (11, False), (35, True)])
def test_enerf_head_kernel(dev, C, viewdir_agg, S):
    head = NeRFHead(C, viewdir_agg=viewdir_agg)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(head, C).items()})
    head = head.to(dev)
    rng = np.random.default_rng(2)
    B, P = 2, 3001  # P not a multiple of the 16-sample tile
    vox = torch.from_numpy(rng.standard_normal((B, P, 8)).astype(np.float32)).to(dev)
    feat = rng.standard_normal((B, S, P, C)).astype(np.float32)
    feat[..., -3:] = rng.uniform(0, 1, (B, S, P, 3))
    feat = torch.from_numpy(feat).to(dev)
    dirs = torch.from_numpy(rng.standard_normal((B, S, P, 4)).astype(np.float32)).to(dev)
    with torch.no_grad():
        params = head.head_params()
        _close_bf16(fused_nerf_head(params, vox, feat, dirs),
                    nerf_head_plain(params, vox, feat, dirs, compute_dtype=torch.bfloat16),
                    nerf_head_plain(params, vox, feat, dirs))
    assert launch_counts()["enerf_head"] == 1


def test_img_sample_kernel_rgb(dev):
    """C = 3, border: the MVSNeRF colour lookup (no 16-byte rows)."""
    rng = np.random.default_rng(3)
    V, H, W, P = 12, 30, 44, 5001
    imgs = torch.from_numpy(rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.uniform(-4, W + 3, (V, P)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(-4, H + 3, (V, P)).astype(np.float32)).to(dev)
    _close(fused_row_sample(imgs, x, y, "border"), row_sample_plain(imgs, x, y, "border"),
           1e-5, 1e-6)
    assert launch_counts()["img_sample"] == 1


def _tri_coords(rng, order, B, D, H, W):
    """(xyz (B, P, 3), samples per ray). ``flat``: 7001 samples anywhere in
    and around the volume, in no order. ``rays<S>``: 101 rays of S samples
    each, ray by ray (P = 101 S leaves a ragged last tile of 1024), each ray
    a line through the volume's depth drifting in (x, y), the rays' starts
    a grid over (x, y) as a target image's pixels map into the MVSNeRF
    volume."""
    if order == "flat":
        P = 7001
        xyz = np.stack([rng.uniform(-3, W + 2, (B, P)), rng.uniform(-3, H + 2, (B, P)),
                        rng.uniform(-3, D + 2, (B, P))], -1)
        return xyz.astype(np.float32), 1
    S, R = int(order[4:]), 101
    px, py = np.arange(R) % 11, np.arange(R) // 11
    t = np.linspace(0.0, 1.0, S)
    x = (px[:, None] * (W - 1) / 10 + 2.0 * t - 1.0)[None] + rng.normal(0, 0.05, (B, R, S))
    y = (py[:, None] * (H - 1) / 9 - 1.5 * t + 0.5)[None] + rng.normal(0, 0.05, (B, R, S))
    z = np.broadcast_to(-0.5 + t * D, (B, R, S)) + rng.normal(0, 0.05, (B, R, S))
    return np.stack([x, y, z], -1).reshape(B, R * S, 3).astype(np.float32), S


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["flat", "rays32", "rays8"])
@pytest.mark.parametrize("C", [4, 8, 16])
def test_tri_sample_kernel(dev, C, order, compute_dtype):
    """Both instances against their plain versions; the samples-per-ray hint
    changes which thread takes which sample, never the result."""
    rng = np.random.default_rng(4)
    B, D, H, W = 2, 9, 13, 17
    vol = torch.from_numpy(rng.standard_normal((B, D, H, W, C)).astype(np.float32)).to(dev)
    xyz, per_ray = _tri_coords(rng, order, B, D, H, W)
    xyz[0, :3] = [[1e10, -1e10, 2.0], [0.0, 0.0, 0.0], [W - 1, H - 1, D - 1]]
    xyz = torch.from_numpy(xyz).to(dev)
    got = fused_tri_sample(vol, xyz, per_ray, compute_dtype)
    want = tri_sample_plain(vol, xyz, per_ray, compute_dtype)
    if compute_dtype == torch.bfloat16:
        _close_bf16(got, want, tri_sample_plain(vol, xyz))
    else:
        _close(got, want, 1e-5, 1e-6)
    assert torch.equal(fused_tri_sample(vol, xyz, 1, compute_dtype), got)
    assert launch_counts()["tri_sample"] == 2


def test_tri_sample_kernel_default_is_bf16(dev):
    """The wrapper's default compute dtype is bf16, as in JAX: the same
    output bit for bit."""
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.standard_normal((2, 9, 13, 17, 8)).astype(np.float32)).to(dev)
    xyz, per_ray = _tri_coords(rng, "rays32", 2, 9, 13, 17)
    xyz = torch.from_numpy(xyz).to(dev)
    a = fused_tri_sample(vol, xyz, per_ray)
    b = fused_tri_sample(vol, xyz, per_ray, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert launch_counts()["tri_sample"] == 2


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("encode_freqs", [0, 10])
def test_renderer_mlp_kernel(dev, encode_freqs, compute_dtype):
    mlp = RendererMLP(MVSNeRFConfig(), 20)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(mlp, 5).items()})
    mlp = mlp.to(dev)
    rng = np.random.default_rng(6)
    B, N = 2, 3001  # a ragged last block
    width = 3 if encode_freqs else 63
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (B, N, width)).astype(np.float32)).to(dev)
    feat = torch.from_numpy(rng.standard_normal((B, N, 20)).astype(np.float32)).to(dev)
    dirs = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        params = mlp.mlp_params()
        got = fused_renderer_mlp(params, pts, feat, dirs, encode_freqs, compute_dtype)
        want = renderer_mlp_plain(params, pts, feat, dirs, encode_freqs, compute_dtype)
        if compute_dtype == torch.bfloat16:
            _close_bf16(got, want, renderer_mlp_plain(params, pts, feat, dirs, encode_freqs))
        else:
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
    assert launch_counts()["renderer_mlp"] == 1


def test_renderer_mlp_kernel_default_is_bf16(dev):
    """The wrapper's default compute dtype is bf16, as in JAX: the same
    output as compute_dtype=torch.bfloat16, bit for bit."""
    mlp = RendererMLP(MVSNeRFConfig(), 20)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(mlp, 7).items()})
    mlp = mlp.to(dev)
    rng = np.random.default_rng(8)
    pts, feat, dirs = (torch.from_numpy(rng.standard_normal((1, 777, w)).astype(np.float32)).to(dev)
                       for w in (3, 20, 3))
    with torch.no_grad():
        params = mlp.mlp_params()
        a = fused_renderer_mlp(params, pts, feat, dirs, 10)
        b = fused_renderer_mlp(params, pts, feat, dirs, 10, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert launch_counts()["renderer_mlp"] == 2


def _close_scaled(got, want, name):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(float(want.abs().max()), 1e-30), (name, err)


def _warp_case(dev, rig, C, seed):
    B, S, Hs, Ws, Ht, Wt, D = 2, 3, 40, 56, 20, 28, 7
    b = make_scene_batch(B=B, n_views=S, H=Hs, W=Ws, seed=seed, rig=rig)
    t = {k: torch.from_numpy(v).to(dev) for k, v in b.items() if k != "src_inps"}
    pm = geometry.proj_mats(t["src_ixts"], t["src_exts"], t["tar_ixt"], t["tar_ext"],
                            1.0, Ht / Hs).contiguous()
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((B, S, Hs, Ws, C)).astype(np.float32)).to(dev)
    dv = torch.from_numpy(rng.uniform(0.2, 8.0, (B, D, Ht, Wt)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, D, Ht, Wt, C)).astype(np.float32)).to(dev)
    return feats, pm, dv, g


def taps_moved_share(feats, pm, dv) -> float:
    """The share of a run's planes (after its first) whose taps lie at
    another pixel than the plane before's, where the backward kernel adds
    the shares it summed in registers to d feats (csrc/warp_variance_bwd.cu),
    from the voxels' coordinates and the kernels' runs of planes."""
    B, S, Hs, Ws, C = feats.shape
    ND = sweep_tile(C, dv.shape[1])[2]
    moved = total = 0
    for b in range(B):
        for s in range(S):
            xu, yu = cost_volume.warp_coords(pm[b, s], dv[b])
            x0 = torch.floor(xu.clamp(-2, Ws + 1))
            y0 = torch.floor(yu.clamp(-2, Hs + 1))
            within = torch.arange(1, dv.shape[1], device=dv.device) % ND != 0
            step = (x0[1:] != x0[:-1]) | (y0[1:] != y0[:-1])
            moved += int(step[within].sum())
            total += int(within.sum()) * step[0].numel()
    return moved / total


# In every case the taps of a run's planes stay put at some planes (their
# shares summed in registers) and move at others (added to device memory in
# mid-run). The rig cases take random depths per voxel: their taps move at
# half the planes or more. "planes" sweeps 16 planes of the cascade's first
# level (uniform in disparity) on the forward rig, as the main path does:
# the taps move at about one plane in seven.
@pytest.mark.parametrize("rig,C,depths", [("orbit", 8, "random"), ("forward", 16, "random"),
                                          ("orbit", 32, "random"), ("forward", 32, "planes")])
def test_warp_variance_bwd_kernel(dev, rig, C, depths):
    feats, pm, dv, g = _warp_case(dev, rig, C, 40 + C)
    if depths == "planes":
        near_far = torch.tensor([[1.5, 6.0]] * feats.shape[0], device=dev)
        dv = cost_volume.initial_depth_values(near_far, 16, *dv.shape[2:], True)
        g = torch.randn((*dv.shape, C), generator=torch.Generator(dev).manual_seed(C),
                        device=dev)
    assert 0.05 < taps_moved_share(feats, pm, dv) < 0.95
    got = warp_variance_bwd(feats, pm, dv, g)
    want = warp_variance_bwd_plain(feats, pm, dv, g)
    for a, b, name in zip(got, want, ("d_feats", "d_depth")):
        _close_scaled(a, b, name)
    assert launch_counts()["warp_variance_bwd"] == 1


@pytest.mark.parametrize("P", SAMPLE_COUNTS)
@pytest.mark.parametrize("C", SAMPLE_WIDTHS)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_img_sample_bwd_kernel(dev, padding_mode, C, P):
    imgs, x, y, g = _sample_case(dev, 7, C, P)
    got = row_sample_bwd(imgs, x, y, g, padding_mode)
    want = row_sample_bwd_plain(imgs, x, y, g, padding_mode)
    for a, b, name in zip(got, want, ("d_imgs", "d_x", "d_y")):
        _close_scaled(a, b, name)
    assert launch_counts()["img_sample_bwd"] == 1


@pytest.mark.parametrize("C", [11, 35])
def test_img_sample_bwd_coordinate_cotangents_are_deterministic(dev, C):
    """d x and d y are summed over channels in shared memory in channel
    order, with no atomic: two launches give the same bits."""
    imgs, x, y, g = _sample_case(dev, 8, C, 5001)
    _, dx1, dy1 = row_sample_bwd(imgs, x, y, g, "border")
    _, dx2, dy2 = row_sample_bwd(imgs, x, y, g, "border")
    torch.cuda.synchronize()
    assert torch.equal(dx1, dx2) and torch.equal(dy1, dy2)
    assert float(dx1.abs().max()) > 0 and float(dy1.abs().max()) > 0


def test_autograd_functions_launch_forward_and_backward_kernels(dev):
    """On the card the autograd Functions launch the forward kernel, then
    the backward kernel; their gradients match the plain backward versions."""
    feats, pm, dv, g = _warp_case(dev, "forward", 16, 60)
    f, d = feats.clone().requires_grad_(), dv.clone().requires_grad_()
    got = torch.autograd.grad(torch.sum(fused_warp_variance_diff(f, pm, d) * g), (f, d))
    for a, b, name in zip(got, warp_variance_bwd_plain(feats, pm, dv, g), ("d_feats", "d_depth")):
        _close_scaled(a, b, name)
    rng = np.random.default_rng(61)
    imgs = torch.from_numpy(rng.standard_normal((4, 20, 30, 35)).astype(np.float32)).to(dev)
    xy = [torch.from_numpy(rng.uniform(-2, n + 1, (4, 900)).astype(np.float32)).to(dev)
          for n in (30, 20)]
    ct = torch.from_numpy(rng.standard_normal((4, 900, 35)).astype(np.float32)).to(dev)
    args = [a.clone().requires_grad_() for a in (imgs, *xy)]
    got = torch.autograd.grad(torch.sum(fused_row_sample_diff(*args) * ct), args)
    for a, b, name in zip(got, row_sample_bwd_plain(imgs, *xy, ct, "border"),
                          ("d_imgs", "d_x", "d_y")):
        _close_scaled(a, b, name)
    counts = launch_counts()
    assert [counts[k] for k in ("warp_variance", "warp_variance_bwd", "img_sample",
                                "img_sample_bwd")] == [1, 1, 1, 1]


@pytest.mark.parametrize("n_views", [2, 4])
def test_enerf_eval_renders_any_view_count(dev, n_views):
    """A plain ENeRF eval frame over 2 or 4 source views renders on the card
    through the head kernel (the DTU recipe's view counts), within 45 dB of
    the port on the CPU."""
    cas = CascadeConfig(render_if=(False, True))
    batch = make_scene_batch(B=1, n_views=n_views, H=64, W=96, seed=n_views, rig="forward")
    state = {k: torch.from_numpy(v) for k, v in random_state_dict(ENeRF(cas, "cpu"), 1).items()}
    outs = {}
    for device in ("cuda", "cpu"):
        model = ENeRF(cas, device=device)
        model.load_state_dict(state, strict=True)
        with torch.no_grad():
            outs[device] = model(to_tensors(batch, model.device))["rgb_level1"].cpu()
    assert launch_counts()["enerf_head"] == 1
    assert bool(torch.isfinite(outs["cuda"]).all())
    mse = float(((outs["cuda"] - outs["cpu"]) ** 2).mean())
    assert -10 * np.log10(mse) > 45.0


def _free_workspace(tmp_path):
    """A Free scene of 16 images at 64x96 (each camera turned its own way)
    and the repository root, where configs' ``parent_cfg`` paths resolve."""
    from pathlib import Path

    from boostmvsnerfs_torch.utils.synthetic import write_free_scene

    ws = str(tmp_path)
    write_free_scene(f"{ws}/Free", "grass", 16, 64, 96, rig="varied")
    return ws, Path(__file__).resolve().parents[1]


def test_render_novel_path_frame_on_the_card(dev, tmp_path, monkeypatch):
    """One spiral ``render_novel_path`` frame on the card (64x96, K=4 of
    20): the pre-pass's 5 chunks launch the warp twice each, then the
    frame's warps, sampler and head; rgb within 45 dB of the CPU port's
    frame. (Not an interpolated path's first frame: its camera is a source
    view's, and the coverage masks step at that view's border, ROADMAP
    fault 4.)"""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.config import make_cfg
    from boostmvsnerfs_torch.eval.visualizer import Visualizer

    ws, repo = _free_workspace(tmp_path)
    monkeypatch.chdir(repo)
    cfg = make_cfg("configs/exps/evaluate/enerf_ours/free_eval.yaml",
                   ["workspace", ws, "scene", "grass", "test_dataset.input_h_w", "[64, 96]",
                    "write_video", "false"])
    frames = []
    original = Visualizer.visualize
    monkeypatch.setattr(Visualizer, "visualize", lambda self, out, batch: (
        frames.append(out["rgb_level1"].cpu().numpy()), original(self, out, batch))[1])
    reset_launch_counts()
    out = runner.render_novel_path(cfg, n_frames=1, path_type="spiral")
    counts = launch_counts()
    assert [counts[k] for k in ("warp_variance", "img_sample", "enerf_head")] == [12, 1, 1]
    runner.render_novel_path(cfg, n_frames=1, path_type="spiral", device="cpu")
    assert out["frames"] == 1 and len(frames) == 2
    assert -10 * np.log10(np.mean((frames[0] - frames[1]) ** 2)) > 45.0


def test_run_train_step_on_the_card(dev, tmp_path, monkeypatch):
    """One ``run_train(cfg)`` step of the fine-tuning recipe on the card
    (64x96, batch 1, K=4, both levels on full images, no validation): the
    f32 warp and the sampler with their backward kernels, and the loss
    within 1e-4 of the CPU port's from the same pretrain weights and view
    selection."""
    import shutil

    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.config import make_cfg
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    ws, repo = _free_workspace(tmp_path)
    monkeypatch.chdir(repo)
    opts = ["workspace", ws, "scene", "grass", "train_dataset.input_h_w", "[64, 96]",
            "test_dataset.input_h_w", "[64, 96]", "train.batch_size", "1", "train.epoch", "1",
            "ep_iter", "1", "eval_ep", "0"]
    cfgs = {d: make_cfg("configs/exps/finetune/enerf_ours/free/base.yaml",
                        opts + ["exp_name_tag", d]) for d in ("cuda", "cpu")}
    model = runner.make_network(cfgs["cpu"], "cpu")
    CheckpointManager(f"{ws}/trained_model/pretrain/enerf").save(
        {"model": {k: torch.from_numpy(v) for k, v in random_state_dict(model, 0).items()}}, 0)
    losses = {}
    for d, cfg in cfgs.items():
        if d == "cpu":
            shutil.copytree(cfgs["cuda"].result_dir, cfg.result_dir)
        reset_launch_counts()
        runner.run_train(cfg, device=d, on_record=lambda kind, state, r, d=d:
                         losses.setdefault(d, r["loss"]))
        if d == "cuda":
            counts = launch_counts()
            # the pre-pass: 14 train views of 1 combination and 2 test views
            # of 5 chunks, 2 warps each; then the step
            assert counts["warp_variance"] == 2 * 14 + 2 * 5 * 2 + 2
            assert [counts[k] for k in ("warp_variance_bwd", "img_sample",
                                        "img_sample_bwd")] == [2, 2, 2]
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


def _mvs_batch(seed=0, rays=None):
    """BoostMVSNeRF at 32x64 (4 views, K=2 of C(4,3)); ``rays`` random rays
    with targets, or every pixel. The target camera sits between source
    frames 1 and 2: on frame 2, where ``make_scene_batch`` puts it, border
    rays project onto that view's frame edges and its in-frame masks flip
    between two builds by rounding (ROADMAP fault 4)."""
    from boostmvsnerfs_torch.utils.synthetic import look_at_ext, mvsnerf_batch

    sub = {0: rays} if rays else None
    b = make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True, seed=seed, rig="forward",
                         render_scales=(1.0,), ray_subsample=sub, with_targets=bool(rays))
    pos = np.array([0.15 * np.sin(0.75), 0.04 * np.cos(1.35), 0.375])  # the rig's path at 1.5
    b["tar_ext"] = look_at_ext(pos, target=pos + np.array([0.0, 0.0, 5.0]))[None]
    out = mvsnerf_batch(b, k_best=(0, 3))
    if rays:
        out["ray_idx_0"], out["rgb_0"] = b["ray_idx_0"], b["rgb_0"]
    return out


@pytest.mark.parametrize("net_type", ["v1", "v2", "color_fusion"])
def test_mvsnerf_head_frames_on_the_card(dev, net_type):
    """A BoostMVSNeRF frame with each plain-MLP head on the card: the volume
    and colour lookups launch once each, the MLP kernel never, and the rgb
    agrees with the CPU port's at over 45 dB."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF

    batch = _mvs_batch()
    rgb = {}
    for d in ("cpu", "cuda"):
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8, net_type=net_type), device=d)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in random_state_dict(model, 0).items()})
        reset_launch_counts()
        rgb[d] = model(batch)["rgb_level0"].cpu().numpy()
    counts = launch_counts()
    assert (counts["tri_sample"], counts["img_sample"], counts["renderer_mlp"]) == (1, 1, 0)
    assert -10 * np.log10(np.mean((rgb["cuda"] - rgb["cpu"]) ** 2)) > 45.0


def test_mvsnerf_train_step_on_the_card(dev):
    """A BoostMVSNeRF train step on the card launches only the colour
    lookup (#3): the volume lookup and the MLP take their plain versions
    under autograd. Its loss is within 1e-4 of the CPU port's. The eval
    render under autograd reaches the volume-lookup kernel, whose wrapper
    refuses a tensor that requires grad."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    cas = CascadeConfig(num=1, loss_weight=(1.0,), render_if=(True,), train_img=(False,))
    batch = _mvs_batch(rays=256)
    losses = {}
    for d in ("cpu", "cuda"):
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8), device=d)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in random_state_dict(model, 0).items()})
        state = create_train_state(model, make_optimizer({"lr": 5e-5}, 10))
        reset_launch_counts()
        losses[d] = float(make_train_step(model, cas=cas)(state, batch)["loss"])
    assert {k: v for k, v in launch_counts().items() if v} == {"img_sample": 1}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    model.eval()
    with pytest.raises(RuntimeError, match="not differentiable"):
        model.render(to_tensors(batch, dev))
