"""The frozen plain reference against the port, on the CPU at a small size:
on the same weights and inputs, the reference with every kernel's plain
version in float32 equals the port's CPU path (whose kernels take their
float32 plain versions there), and the reference's kernels at the card's
precisions equal the port's plain versions at those precisions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness.weights import seeded_state_dict
from portbench.reference import boost_enerf as ref_enerf
from portbench.reference import boost_mvsnerf as ref_mvsnerf
from portbench.reference.plain import kernels
from portbench.tests.portbench_support import config_file

torch.set_num_threads(4)
ATOL = 2e-5


def _enerf_pair(seed: int):
    from boostmvsnerfs_torch import runner

    cfg = config_file("boost_enerf_free")["cfg"]
    port = runner.make_network(cfg, "cpu")
    weights = seeded_state_dict(port.state_dict(), seed, torch.device("cpu"))
    port.load_state_dict(weights)
    return port, ref_enerf.build(cfg, weights, torch.device("cpu")), cfg


def _batch(H: int, W: int, seed: int, k_best=(0, 7, 13, 19)):
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    b = make_scene_batch(B=1, n_views=6, H=H, W=W, boost=True, seed=seed, rig="forward")
    b["k_best"] = np.asarray([k_best], np.int32)
    return b


def test_enerf_frame_equals_port():
    port, ref, _ = _enerf_pair(5)
    batch = _batch(64, 96, 1)
    want = port(batch)
    with kernels.kernel_precision(torch.float32):
        got = ref_enerf.frame(ref, batch)
    for k in ("rgb_level1", "depth_level1", "depth_mvs_level1"):
        torch.testing.assert_close(got[k], want[k], atol=ATOL, rtol=1e-5)


def test_enerf_masks_and_picks_equal_port():
    from boostmvsnerfs_torch import runner

    port, ref, _ = _enerf_pair(6)
    batch = _batch(64, 96, 2)
    combos = batch["combos"]
    want = port.forward_view_selection(batch, combos).numpy()
    with kernels.kernel_precision(torch.float32):
        got = ref_enerf.coverage(ref, batch, combos)
    np.testing.assert_allclose(got, want, atol=ATOL)
    picks = runner.greedy_select(port, batch, combos, 4)[0].tolist()
    mine = ref_enerf.search_k_best(got[:, 0], 4)
    assert mine == picks[:len(mine)]


def test_mvsnerf_frame_in_row_blocks_equals_port_staged():
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.utils.synthetic import mvsnerf_batch

    cfg = config_file("boost_mvsnerf_free")["cfg"]
    port = runner.make_network(cfg, "cpu")
    weights = seeded_state_dict(port.state_dict(), 7, torch.device("cpu"))
    port.load_state_dict(weights)
    ref = ref_mvsnerf.build(cfg, weights, torch.device("cpu"))
    batch = mvsnerf_batch(_batch(96, 128, 3), k_best=(1, 5, 9, 14))
    want = runner.make_forward(cfg, port)(batch)  # StagedMVSNeRF: 3 blocks of 32 rows
    with kernels.kernel_precision(torch.float32):
        got = ref_mvsnerf.frame(ref, batch)
    for k in ("rgb_level0", "depth_level0"):
        torch.testing.assert_close(got[k], want[k], atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("kernel", ["warp_variance", "enerf_head", "tri_sample", "renderer_mlp"])
def test_card_precision_equals_port_plain_versions(kernel):
    """Each reference kernel at the card's precision (bf16 operands,
    float32 sums) equals the port's plain version at bfloat16."""
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    bf16 = torch.bfloat16
    if kernel == "warp_variance":
        from boostmvsnerfs_torch.ops.cuda.warp_variance import warp_variance_plain

        feats = rnd(1, 3, 12, 16, 8)
        pm = torch.tensor([[[1.0, 0.02, 0.5, 0.3], [0.01, 1.0, 0.2, -0.1], [0.0, 0.0, 1.0, 0.0]]])
        pm = pm.expand(1, 3, 3, 4).contiguous()
        dv = 2.0 + torch.rand(1, 4, 6, 8, generator=g)
        want = warp_variance_plain(feats, pm, dv, bf16)
        got = kernels.fused_warp_variance(feats, pm, dv, bf16)
    elif kernel == "enerf_head":
        from boostmvsnerfs_torch.models.nerf_head import NeRFHead
        from boostmvsnerfs_torch.ops.cuda.enerf_head import nerf_head_plain

        params = NeRFHead(11).head_params()
        vox, feat, dirs = rnd(1, 50, 8), rnd(1, 3, 50, 11), rnd(1, 3, 50, 4)
        want = nerf_head_plain(params, vox, feat, dirs, bf16)
        got = kernels.fused_nerf_head(params, vox, feat, dirs)
    elif kernel == "tri_sample":
        from boostmvsnerfs_torch.ops.cuda.tri_sample import tri_sample_plain

        vol = rnd(1, 6, 7, 9, 8)
        xyz = torch.rand(1, 200, 3, generator=g) * torch.tensor([9.0, 7.0, 6.0]) - 0.5
        want = tri_sample_plain(vol, xyz, 1, bf16)
        got = kernels.fused_tri_sample(vol, xyz, 1)
    else:
        from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig, RendererMLP
        from boostmvsnerfs_torch.ops.cuda.renderer_mlp import renderer_mlp_plain

        params = RendererMLP(MVSNeRFConfig(), 20).mlp_params()
        pts, feat, dirs = rnd(1, 64, 3), rnd(1, 64, 20), rnd(1, 64, 3)
        want = renderer_mlp_plain(params, pts, feat, dirs, 10, bf16)
        got = kernels.fused_renderer_mlp(params, pts, feat, dirs, 10)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("split, n_views", [("test", 6), ("train", 3), ("train", 4)])
def test_reference_reads_the_ports_inputs_from_the_files(tmp_path, split, n_views):
    """The reference's own reading of a scene's files (cameras, depth range,
    source views, images, each level's rays and targets) equals what the
    port's Free dataset decodes from them."""
    from boostmvsnerfs_torch.data.free import FreeDataset
    from boostmvsnerfs_torch.models.enerf import CascadeConfig

    from portbench.harness import scene
    from portbench.reference.plain import data

    H, W = 64, 96
    scene.write_free_scene(str(tmp_path), "walk", 24, H, W, seed=2**31 + 11)
    cfg = config_file("boost_enerf_free", (H, W))["finetune"]
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    ds = FreeDataset(str(tmp_path), split, cas, input_h_w=(H, W), scenes=["walk"],
                     n_train_views=n_views, n_test_views=n_views)
    for index in (0, len(ds) - 1):
        port = ds.get_sample(index, input_views_num=n_views)
        mine = data.sample(str(tmp_path / "walk"), port["meta"]["tar_view"], n_views, H, W,
                           cas.render_scale, with_rgb=split == "train")
        for k, v in mine.items():
            np.testing.assert_array_equal(v, port[k], err_msg=k)
