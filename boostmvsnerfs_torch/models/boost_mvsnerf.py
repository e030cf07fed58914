"""BoostMVSNeRF: multi cost-volume fusion on the MVSNeRF backbone
(counterpart of ``boostmvsnerfs_tpu/models/boost_mvsnerf.py``: the view
selection's coverage masks and the fused forward, eval and training).

Batch convention adds to MVSNeRF's: combos (n_combos, I) view-combination
table, k_best (B, K) combination ids from the cached view selection.
"""

from __future__ import annotations

import torch

from boostmvsnerfs_torch.models.boost_enerf import _take_views
from boostmvsnerfs_torch.models.enerf import to_tensors
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRF, depth_line, mvs_proj_mats
from boostmvsnerfs_torch.ops import geometry, render
from boostmvsnerfs_torch.utils.profiling import spanned


# depth samples per ray of the view selection's coverage masks (JAX
# models/boost_mvsnerf.py:44)
COVERAGE_SAMPLES = 128


class BoostMVSNeRF(MVSNeRF):
    """MVSNeRF + multi cost-volume fusion."""

    def _coverage(self, batch: dict, vis: torch.Tensor, combos: torch.Tensor) -> torch.Tensor:
        """Coverage masks (n, B, H, W) of the combinations ``combos`` (n, I)
        from every view's visibility of the samples ``vis`` (B, N, P), P =
        H*W*COVERAGE_SAMPLES: the fraction of a combination's views seeing
        each sample, over the sample count, composited as pseudo-radiance;
        the channel mean of the rgb."""
        n, I = combos.shape
        B, _, H, W = batch["all_src_inps"].shape[:4]
        m = vis[:, combos.reshape(-1)].reshape(B, n, I, -1).sum(2) / I / COVERAGE_SAMPLES
        m = m.reshape(B * n, H * W, COVERAGE_SAMPLES)
        out = render.composite(m[..., None].expand(*m.shape, 4), None)
        return out["rgb"].mean(-1).reshape(B, n, H, W).transpose(0, 1)

    def _coverage_visibility(self, batch: dict) -> torch.Tensor:
        """Whether each of the N views sees each of 128 uniform samples per
        ray over the scene's near/far, (B, N, H*W*128) (reference
        boost_mvsnerf calc_mask :23-45), for the rays of every pixel of
        the target view. JAX takes the batch's ``ray_idx_0`` and reshapes to
        the image, so it fails on a training batch of random rays (the
        mvsnerf_ours recipe's pre-pass over its train views, ROADMAP fault
        17); on an eval batch, whose rays are every pixel, the two agree."""
        B, _, H, W = batch["all_src_inps"].shape[:4]
        xy = geometry.flat_idx_to_xy(torch.arange(H * W, device=self.device).expand(B, -1), W)
        ray_o, ray_d = geometry.rays_from_pixels(batch["tar_ixt"], batch["tar_ext"], xy)
        near, far = batch["near_far"][:, 0], batch["near_far"][:, 1]
        z_vals = depth_line(near, far, COVERAGE_SAMPLES)[:, None, :]  # (B, 1, Ns)
        world = ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]
        inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=self.device)
        return render.viewport_visibility(world, batch["all_src_exts"], batch["all_src_ixts"],
                                          inv_scale.expand(B, 2))

    @torch.no_grad()
    def combo_coverage_mask(self, batch: dict, combo) -> torch.Tensor:
        """Coverage mask of one source-view combination ``combo`` (I,),
        (B, H, W): pure geometry, the samples projected into the
        combination's views only."""
        batch = to_tensors(batch, self.device)
        combo = torch.as_tensor(combo, device=self.device).long()
        sub = dict(batch, all_src_exts=batch["all_src_exts"][:, combo],
                   all_src_ixts=batch["all_src_ixts"][:, combo])
        vis = self._coverage_visibility(sub)
        return self._coverage(batch, vis, torch.arange(len(combo), device=self.device)[None])[0]

    @torch.no_grad()
    def forward_view_selection(self, batch: dict, combos) -> torch.Tensor:
        """Coverage masks of all combinations ``combos`` (n_combos, I):
        (n_combos, B, H, W). The samples project into each of the N views
        once; then chunks of ``k_best`` combinations take their views'
        visibility and composite together, so a chunk's peak memory is the
        eval frame's order."""
        batch = to_tensors(batch, self.device)
        combos = torch.as_tensor(combos, device=self.device).long()
        vis = self._coverage_visibility(batch)
        return torch.cat([self._coverage(batch, vis, chunk)
                          for chunk in combos.split(self.cfg.k_best)])

    @spanned("model.volume")
    def frame_volume(self, batch: dict):
        """The render's first two stages on a batch of tensors: the feature
        net once over all N source views; then each of the K selected
        combinations gathers its views, features and depth ranges, K folds
        into the batch axis (B*K), and every combination's volume is built
        with its own near/far. Returns (the sub-batch, whose target cameras
        are repeated K times, the volumes (B*K, D, h+2p, w+2p, 8), near
        (B*K,), far (B*K,))."""
        K = self.cfg.k_best
        B = batch["all_src_inps"].shape[0]
        sel = batch["combos"][batch["k_best"]]  # (B, K, I)
        I = sel.shape[-1]

        def fold(x):
            return _take_views(x, sel.reshape(B, K * I)).reshape(B * K, I, *x.shape[2:])

        sub = {k: fold(batch[f"all_{k}"]) for k in ("src_inps", "src_exts", "src_ixts")}
        sub.update({k: batch[k].repeat_interleave(K, dim=0) for k in ("tar_ext", "tar_ixt")})
        feats = fold(self.extract_features(batch["all_src_inps"]))
        near, far = self.near_far(fold(batch["depth_ranges"]))
        pm = mvs_proj_mats(sub["src_ixts"], sub["src_exts"])
        volume = self.build_volume(sub["src_inps"], feats, pm,
                                   depth_line(near, far, self.cfg.num_samples))
        return sub, volume, near, far

    @spanned("model.render")
    def render_rays(self, sub, volume, ray_idx, near, far) -> dict:
        """The render's last stage: the rays ``ray_idx`` (B, R), repeated
        for each of the K volumes, through ``frame_volume``'s outputs; the K
        radiance fields blend with normalised visibility weights, which
        carry no gradient, in one transmittance integral. Every ray is
        independent of the others."""
        B, K = ray_idx.shape[0], self.cfg.k_best
        raw = self.render_volume(sub, volume, ray_idx.repeat_interleave(K, dim=0), near, far,
                                 with_mask=True)

        def unfold(x):  # (B*K, ...) -> (B, K, ...)
            return x.reshape(B, K, *x.shape[1:])

        return render.composite_blend(unfold(raw["net_output"]),
                                      render.normalize_blend_masks(unfold(raw["mask"])),
                                      unfold(raw["z_vals"]))

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """The render of a batch (numpy arrays or tensors) without
        gradients; the eval render after ``model.eval()``."""
        return self.render(to_tensors(batch, self.device))
