"""BoostENeRF: multi cost-volume fusion on the ENeRF backbone (counterpart of
``boostmvsnerfs_tpu/models/boost_enerf.py``: the view selection's coverage
masks, and the fused forward, eval and training).

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
from boostmvsnerfs_torch.utils.profiling import span, spanned


def view_combinations(n_views: int, n_input: int) -> np.ndarray:
    """Static combination table, (C(n_views, n_input), n_input) int32, in
    lexicographic (``torch.combinations``) order."""
    return np.array(list(itertools.combinations(range(n_views), n_input)), dtype=np.int32)


def greedy_steps(masks: np.ndarray, k: int) -> tuple[list[int], list[float]]:
    """Greedy coverage maximisation over combination masks (n_combos, H, W),
    step by step: each step picks the combination covering the most
    not-yet-covered area (soft masks in [0, 1]; the lowest id on a tie),
    and the search stops early when nothing improves coverage. Returns the
    picks and each step's margin: the winner's covered share minus the
    best other candidate's (or minus 0, the share a pick must exceed)."""
    n, H, W = masks.shape
    prev = np.ones((H, W), np.float32)
    picks: list[int] = []
    margins: list[float] = []
    for _ in range(k):
        ratios = [-np.inf if i in picks else float((masks[i] * prev).sum()) / (H * W)
                  for i in range(n)]
        best = int(np.argmax(ratios))
        if ratios[best] <= 0.0:
            break
        margins.append(ratios[best] - max(max(ratios[:best] + ratios[best + 1:], default=0.0),
                                          0.0))
        prev = prev * (1.0 - masks[best])
        picks.append(best)
    return picks, margins


def search_k_best(masks: np.ndarray, k: int) -> list[int]:
    """The greedy picks (``greedy_steps``); ``[0]`` when nothing improves
    coverage."""
    return greedy_steps(masks, k)[0] or [0]


def _take_views(x: torch.Tensor, views: torch.Tensor) -> torch.Tensor:
    """Gather (B, I, ...) from (B, N, ...) with per-batch view ids (B, I)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], views]


class BoostENeRF(ENeRF):
    """ENeRF + multi cost-volume fusion."""

    def fold_views(self, batch: dict, feats_all: dict, sel: torch.Tensor) -> tuple[dict, dict]:
        """Each batch entry's C view combinations ``sel`` (B, C, I) gather
        their views and FPN features (``feats_all``, over all N views), and
        C folds into the batch axis (B*C), so every later stage runs once
        for all C volumes. Returns (feats, sub-batch); the sub-batch's
        target-side tensors and rays are repeated C times."""
        B, C, I = sel.shape
        views = sel.reshape(B, C * I)

        def fold(x):
            return _take_views(x, views).reshape(B * C, I, *x.shape[2:])

        feats = {lvl: fold(f) for lvl, f in feats_all.items()}
        sub = {k: fold(batch[f"all_{k}"]) for k in ("src_inps", "src_exts", "src_ixts")}
        for k in ["tar_ext", "tar_ixt", "near_far"] + [f"ray_idx_{i}" for i in range(self.cas.num)]:
            if k in batch:
                sub[k] = batch[k].repeat_interleave(C, dim=0)
        return feats, sub

    def fold_combinations(self, batch: dict) -> tuple[dict, dict]:
        """The FPN once over all N source views; then the K selected
        combinations (``combos[k_best]``) fold into the batch axis
        (``fold_views``)."""
        feats_all = self.extract_features(batch["all_src_inps"])
        with span("model.features"):
            return self.fold_views(batch, feats_all, batch["combos"][batch["k_best"]])

    # ------------------------------------------------------------------
    # view selection
    # ------------------------------------------------------------------

    def coverage(self, feats: dict, sub: dict) -> torch.Tensor:
        """Coverage mask of each entry of a (folded) sub-batch, (B, H_r,
        W_r): the full cascade on its views, the last level's samples, and
        their viewport-visibility fraction over N_samples composited as
        pseudo-radiance (reference lib/networks/boost_enerf/network.py:
        22-69); the channel mean of the composited rgb. JAX renders the
        last level with ``return_raw`` and reads only its mask, so its jit
        drops the head and the sampler; here the level stops at the
        samples' positions."""
        cas = self.cas
        last = cas.num - 1
        prev = None
        for i in range(cas.num):
            _, *prev = self.build_level_volume(
                i, feats, sub["src_exts"], sub["src_ixts"], sub["tar_ext"],
                sub["tar_ixt"], sub["near_far"], prev,
            )
        depth, std, nf_map = prev
        B, _, H, W = sub["src_inps"].shape[:4]
        rs = cas.render_scale[last]
        H_r, W_r = int(H * rs), int(W * rs)
        bounds_map = render.ray_bounds_maps(depth, std, nf_map, H_r, W_r, cas.depth_inv[last])
        world_xyz, _, _ = self.sample_rays(last, bounds_map, sub, sub[f"ray_idx_{last}"])
        inv_scale = torch.tensor([W_r - 1, H_r - 1], dtype=torch.float32,
                                 device=world_xyz.device).expand(B, 2)
        m = render.mask_viewport(world_xyz, sub["src_exts"], sub["src_ixts"], inv_scale)
        m = m / cas.num_samples[last]  # (B, N, Ns)
        out = render.composite(m[..., None].expand(*m.shape, 4), None)
        return out["rgb"].mean(-1).reshape(B, H_r, W_r)

    @torch.no_grad()
    def combo_coverage_mask(self, batch: dict, combo) -> torch.Tensor:
        """Coverage mask of one source-view combination ``combo`` (I,),
        (B, H_r, W_r), as the JAX method computes it: the FPN on the
        combination's views only."""
        batch = to_tensors(batch, self.device)
        combo = torch.as_tensor(combo, device=self.device).long()
        sub = {k: batch[f"all_{k}"][:, combo] for k in ("src_inps", "src_exts", "src_ixts")}
        sub.update({k: v for k, v in batch.items() if not k.startswith(("all_", "src_"))})
        return self.coverage(self.extract_features(sub["src_inps"]), sub)

    @torch.no_grad()
    def forward_view_selection(self, batch: dict, combos) -> torch.Tensor:
        """Coverage masks of all combinations ``combos`` (n_combos, I):
        (n_combos, B, H_r, W_r). The FPN runs once over all N views (per
        image, in eval mode: the same function as on each subset); then
        chunks of ``cas.k_best`` combinations fold into the batch axis, so
        a chunk is the eval frame's batch (and its peak memory) and each
        of its kernels (the warp, at every level) launches once per chunk."""
        batch = to_tensors(batch, self.device)
        combos = torch.as_tensor(combos, device=self.device).long()
        B = batch["all_src_inps"].shape[0]
        feats_all = self.extract_features(batch["all_src_inps"])
        masks = []
        for chunk in combos.split(self.cas.k_best):
            feats, sub = self.fold_views(batch, feats_all, chunk.expand(B, *chunk.shape))
            m = self.coverage(feats, sub)
            masks.append(m.reshape(B, len(chunk), *m.shape[1:]).transpose(0, 1))
        return torch.cat(masks)

    @spanned("model.blend")
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
