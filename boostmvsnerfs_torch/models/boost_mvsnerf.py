"""BoostMVSNeRF: multi cost-volume fusion on the MVSNeRF backbone
(counterpart of ``boostmvsnerfs_tpu/models/boost_mvsnerf.py``, fused eval
forward).

Batch convention adds to MVSNeRF's: combos (n_combos, I) view-combination
table, k_best (B, K) combination ids from the cached view selection.
"""

from __future__ import annotations

import torch

from boostmvsnerfs_torch.models.boost_enerf import _take_views
from boostmvsnerfs_torch.models.enerf import to_tensors
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRF, depth_line, mvs_proj_mats
from boostmvsnerfs_torch.ops import render


class BoostMVSNeRF(MVSNeRF):
    """MVSNeRF + multi cost-volume fusion. ``combo_coverage_mask`` and
    ``forward_view_selection`` of the JAX module have no counterpart yet."""

    def fused_volumes(self, batch: dict):
        """The feature net once over all N source views; then each of the K
        selected combinations gathers its views, features and depth ranges,
        K folds into the batch axis (B*K), and every combination's volume is
        built with its own near/far. Returns (sub-batch, volumes (B*K, D,
        h+2p, w+2p, 8), near (B*K,), far (B*K,)); the sub-batch's target
        cameras and rays are repeated K times."""
        K = self.cfg.k_best
        B = batch["all_src_inps"].shape[0]
        sel = batch["combos"][batch["k_best"]]  # (B, K, I)
        I = sel.shape[-1]

        def fold(x):
            return _take_views(x, sel.reshape(B, K * I)).reshape(B * K, I, *x.shape[2:])

        sub = {k: fold(batch[f"all_{k}"]) for k in ("src_inps", "src_exts", "src_ixts")}
        sub.update({k: batch[k].repeat_interleave(K, dim=0)
                    for k in ("tar_ext", "tar_ixt", "ray_idx_0")})
        feats = fold(self.extract_features(batch["all_src_inps"]))
        near, far = self.near_far(fold(batch["depth_ranges"]))
        pm = mvs_proj_mats(sub["src_ixts"], sub["src_exts"])
        volume = self.build_volume(sub["src_inps"], feats, pm,
                                   depth_line(near, far, self.cfg.num_samples))
        return sub, volume, near, far

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """Fused multi-cost-volume render: the K radiance fields blend with
        normalised visibility weights in one transmittance integral."""
        batch = to_tensors(batch, self.device)
        B, K = batch["all_src_inps"].shape[0], self.cfg.k_best
        sub, volume, near, far = self.fused_volumes(batch)
        raw = self.render_volume(sub, volume, sub["ray_idx_0"], near, far, with_mask=True)

        def unfold(x):  # (B*K, ...) -> (B, K, ...)
            return x.reshape(B, K, *x.shape[1:])

        out = render.composite_blend(unfold(raw["net_output"]),
                                     render.normalize_blend_masks(unfold(raw["mask"])),
                                     unfold(raw["z_vals"]))
        return {f"{k}_level0": v for k, v in out.items()}
