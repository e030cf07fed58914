"""The counted work of BoostMVSNeRF's fine-tuning step, built on
``roofline.py``'s pieces: the forward of one step by stage ({stage:
Roofline} and 'total'), and the step's operations as three times that
forward (the forward and the backward's two products, the usual
convention).

A step of ``batch`` targets, each over ``n_views`` source views, builds
``batch * k_best`` padded volumes and renders ``n_rays`` rays of ``D``
samples through each: the feature net over every source image and the
plain warp of each volume (``roofline.mvsnerf_render_costs``' stages at
those counts), the U-Net's ten convolutions over each volume (each layer
at its own input and output sizes: a strided layer over its output voxels,
a transposed one over its input voxels), then the trilinear and colour
lookups and the ``v0`` MLP over the volumes' ``n_rays * D`` samples. Every
operation of the step runs in float32, the MLP's products too, so none is
counted on the tensor cores; elementwise work is left out, as in
``roofline.py``."""

from __future__ import annotations

from portbench.harness import roofline
from portbench.harness.roofline import Roofline


def unet_flops(D, hp, wp) -> int:
    """The MVSNeRF U-Net's operations over one (D, hp, wp) volume: conv0 41
    -> 8; conv1 / conv2 8 -> 16 (stride 2) / 16 -> 16 at half size, conv3 /
    conv4 at a quarter, conv5 / conv6 at an eighth; the transposed conv7,
    conv9, conv11 back up, each over its input."""
    def vox(s):
        return (D // s) * (hp // s) * (wp // s)

    def conv(v, cin, cout):
        return roofline._conv3d(v, 1, 1, cin, cout)

    return (conv(vox(1), 41, 8) + conv(vox(2), 8, 16) + conv(vox(2), 16, 16)
            + conv(vox(4), 16, 32) + conv(vox(4), 32, 32) + conv(vox(8), 32, 64)
            + conv(vox(8), 64, 64) + conv(vox(8), 64, 32) + conv(vox(4), 32, 16)
            + conv(vox(2), 16, 8))


def step_costs(H, W, batch, n_views, k_best, s_cv, D, pad, mlp_width, mlp_depth, pos_freqs,
               n_rays) -> dict:
    """The forward work of one step by stage, and its 'total'."""
    k, n = batch * k_best, n_rays * D
    frame = roofline.mvsnerf_render_costs(H, W, k, s_cv, D, pad, mlp_width, mlp_depth,
                                          batch * n_views, pos_freqs)
    stages = {s: frame[s] for s in ("features", "warp")}
    dims = (D, H // 4 + 2 * pad, W // 4 + 2 * pad)
    n_vox = dims[0] * dims[1] * dims[2]
    stages["costreg"] = Roofline(k * unet_flops(*dims), k * n_vox * (41 + 8) * 4.0 * 2)
    nbytes, ops = roofline.tri_counts(k * n_vox, k * n, 8)
    stages["tri_sample"] = Roofline(ops, nbytes)
    stages["img_sample"] = roofline._sample_roofline(k * s_cv, H, W, 3, n)
    n_feat = 8 + 4 * s_cv
    macs = roofline.mvsnerf_mlp_macs(mlp_width, mlp_depth, n_feat, 3 + 6 * pos_freqs)
    stages["mlp"] = Roofline(k * n * (2 * 3 * pos_freqs + 2 * macs),
                             k * n * (3 + n_feat + 3 + 4) * 4.0)
    return roofline._total(stages)


def step_flops(cfg: dict) -> float:
    """The operations of one step of the recipe's tree ``cfg``: three times
    the forward's, at the recipe's batch, rays and samples, over the views
    a draw holds (``train_input_views[1]``, at least one combination's)."""
    en, cas, mv = cfg["enerf"], cfg["enerf"]["cas_config"], cfg["mvsnerf"]
    H, W = cfg["train_dataset"]["input_h_w"]
    s_cv = en["cost_volume_input_views"]
    total = step_costs(H, W, cfg["train"]["batch_size"], max(en["train_input_views"][1], s_cv),
                       cas["k_best"], s_cv, cas["num_samples"][0], mv["pad"], mv["mlp_dim"],
                       mv["mlp_depth"], mv["pos_freqs"], cas["num_rays"][0])["total"]
    return 3.0 * (total.flops + total.tc_flops)
