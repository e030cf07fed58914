"""BoostENeRF: multi cost-volume fusion on the ENeRF backbone (counterpart of
``boostmvsnerfs_tpu/models/boost_enerf.py``, fused forward, eval and
training).

Batch convention adds:
  all_src_inps (B, N, H, W, 3), all_src_exts (B, N, 4, 4),
  all_src_ixts (B, N, 3, 3), combos (n_combos, I) view-combination table,
  k_best (B, K) combination ids from the cached view selection.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from boostmvsnerfs_torch.models.enerf import ENeRF, to_tensors
from boostmvsnerfs_torch.ops import render


def view_combinations(n_views: int, n_input: int) -> np.ndarray:
    """Static combination table, (C(n_views, n_input), n_input) int32, in
    lexicographic (``torch.combinations``) order."""
    return np.array(list(itertools.combinations(range(n_views), n_input)), dtype=np.int32)


def search_k_best(masks: np.ndarray, k: int) -> list[int]:
    """Greedy coverage maximisation over combination masks (n_combos, H, W):
    each step picks the combination covering the most not-yet-covered area
    (soft masks in [0, 1]); ``[0]`` when nothing improves coverage."""
    n, H, W = masks.shape
    prev = np.ones((H, W), np.float32)
    results: list[int] = []
    for _ in range(k):
        best_id, best_ratio = None, 0.0
        for i in range(n):
            if i in results:
                continue
            ratio = float((masks[i] * prev).sum()) / (H * W)
            if ratio > best_ratio:
                best_ratio, best_id = ratio, i
        if best_id is None:
            break
        prev = prev * (1.0 - masks[best_id])
        results.append(best_id)
    if not results:
        results.append(0)
    return results


def _take_views(x: torch.Tensor, views: torch.Tensor) -> torch.Tensor:
    """Gather (B, I, ...) from (B, N, ...) with per-batch view ids (B, I)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], views]


class BoostENeRF(ENeRF):
    """ENeRF + multi cost-volume fusion."""

    def fold_combinations(self, batch: dict) -> tuple[dict, dict]:
        """The FPN once over all N source views; then each of the K selected
        combinations gathers its views and features, and K folds into the
        batch axis (B*K), so every later stage runs once for all K volumes.
        Returns (feats, sub-batch); the sub-batch's target-side tensors and
        rays are repeated K times."""
        K = self.cas.k_best
        B = batch["all_src_inps"].shape[0]
        sel = batch["combos"][batch["k_best"]]  # (B, K, I)
        I = sel.shape[-1]
        views = sel.reshape(B, K * I)

        def fold(x):
            return _take_views(x, views).reshape(B * K, I, *x.shape[2:])

        feats = {lvl: fold(f)
                 for lvl, f in self.extract_features(batch["all_src_inps"]).items()}
        sub = {k: fold(batch[f"all_{k}"]) for k in ("src_inps", "src_exts", "src_ixts")}
        for k in ["tar_ext", "tar_ixt", "near_far"] + [f"ray_idx_{i}" for i in range(self.cas.num)]:
            if k in batch:
                sub[k] = batch[k].repeat_interleave(K, dim=0)
        return feats, sub

    def blend(self, raw: dict, B: int) -> dict:
        """The K radiance fields of ``render_rays(..., return_raw=True)``
        (batch B*K) blended with normalised visibility weights in one
        transmittance integral: {'rgb', 'weights', 'depth'} per batch entry."""
        K = self.cas.k_best

        def unfold(x):  # (B*K, ...) -> (B, K, ...)
            return x.reshape(B, K, *x.shape[1:])

        return render.composite_blend(unfold(raw["net_output"]),
                                      render.normalize_blend_masks(unfold(raw["mask"])),
                                      unfold(raw["z_vals"]))

    def render(self, batch: dict) -> dict:
        """Fused multi-cost-volume forward on a batch of tensors on the
        model's device, in the module's mode. Differentiable."""
        cas = self.cas
        B, K = batch["all_src_inps"].shape[0], cas.k_best
        feats, sub = self.fold_combinations(batch)
        ret = {}
        prev = None
        for i in range(cas.num):
            feat_vol, depth, std, nf_map = self.build_level_volume(
                i, feats, sub["src_exts"], sub["src_ixts"], sub["tar_ext"],
                sub["tar_ixt"], sub["near_far"], prev,
            )
            prev = (depth, std, nf_map)
            if not cas.render_if[i]:
                continue
            raw = self.render_level(i, feats, feat_vol, depth, std, nf_map, sub,
                                    sub[f"ray_idx_{i}"], return_raw=True)
            out = self.blend(raw, B)
            depth0 = depth.reshape(B, K, *depth.shape[1:])[:, 0]
            out["depth_mvs"] = 1.0 / depth0 if cas.depth_inv[i] else depth0
            out["std"] = std.reshape(B, K, *std.shape[1:])[:, 0]
            ret.update({f"{key}_level{i}": v for key, v in out.items()})
        return ret

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """The render of a batch (numpy arrays or tensors) without
        gradients; the eval render after ``model.eval()``."""
        return self.render(to_tensors(batch, self.device))
