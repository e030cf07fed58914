"""The plain reference of the BoostENeRF family: the eval frame, and the
view selection's coverage masks with the greedy search.

The model is ``plain/boost_enerf.py``'s, built from a configuration tree
and given the benchmark's weights; its kernels are plain versions at the
card's precisions (``plain/kernels.py``). The frame runs as the port's
``StagedENeRF`` without a mesh does: the model's forward.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain.boost_enerf import BoostENeRF, search_k_best, view_combinations
from portbench.reference.plain.enerf import CascadeConfig

__all__ = ["build", "frame", "coverage", "search_k_best", "view_combinations"]


def build(cfg: dict, state_dict: dict, device) -> BoostENeRF:
    """The reference model of ``cfg`` (the whole configuration tree) on
    ``device``, in eval mode, holding ``state_dict``."""
    model = BoostENeRF(CascadeConfig.from_cfg(cfg["enerf"]), device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


@torch.no_grad()
def frame(model: BoostENeRF, batch: dict) -> dict:
    """The eval frame's outputs of a batch (numpy arrays or tensors) that
    carries ``combos`` and ``k_best``."""
    return model(batch)


@torch.no_grad()
def coverage(model: BoostENeRF, batch: dict, combos: np.ndarray) -> np.ndarray:
    """The coverage masks of every combination, (n_combos, B, H_r, W_r)."""
    return model.forward_view_selection(batch, combos).cpu().numpy()


# ---------------------------------------------------------------- fine-tuning

BETAS = (0.9, 0.999)
GRAD_CLIP = 40.0


def level_ray_blocks(ray_blocks: int, n_rays: int, n_max: int, rows: int,
                     full_raster: bool) -> int:
    """A level's ray blocks: max(1, ray_blocks * n_rays // n_max), rounded
    down to a divisor of its rows (whole-row blocks) or of its rays."""
    target = max(1, (ray_blocks * n_rays) // max(n_max, 1))
    return next(d for d in range(target, 0, -1) if (rows if full_raster else n_rays) % d == 0)


def blocked_loss(model: BoostENeRF, batch: dict, ray_blocks: int, fault: str | None = None):
    """The fine-tuning loss of a batch of tensors: the FPN, every level's
    volume once, each rendered level's rays in blocks recomputed in the
    backward (``torch.utils.checkpoint``), the K fields blended, and the
    weighted colour MSE over the levels. Blocks change no value. ``fault``
    plants one for the check's readings: ``half_batch`` takes the loss over
    the first half of the images, ``altered`` renders every colour 2%
    darker."""
    from torch.utils.checkpoint import checkpoint

    cas = model.cas
    B, K = batch["all_src_inps"].shape[0], cas.k_best
    feats, sub = model.fold_combinations(batch)
    n_max = max(batch[f"ray_idx_{j}"].shape[1] for j in range(cas.num) if cas.render_if[j])
    H, W = batch["all_src_inps"].shape[2:4]
    loss = torch.zeros((), device=model.device)
    prev = None
    for i in range(cas.num):
        feat_vol, depth, std, nf_map = model.build_level_volume(
            i, feats, sub["src_exts"], sub["src_ixts"], sub["tar_ext"], sub["tar_ixt"],
            sub["near_far"], prev)
        prev = (depth, std, nf_map)
        if not cas.render_if[i]:
            continue
        ray_idx = batch[f"ray_idx_{i}"]
        N = ray_idx.shape[1]
        H_r, W_r = int(H * cas.render_scale[i]), int(W * cas.render_scale[i])
        nb = level_ray_blocks(ray_blocks, N, n_max, H_r, N == H_r * W_r and cas.train_img[i])
        maps = model.level_maps(i, feats, depth, std, nf_map, sub["src_inps"])

        def block(ridx, feat_vol, bounds_map, img_feat_rgb, i=i):
            o = model.render_rays(i, (bounds_map, img_feat_rgb), feat_vol, sub,
                                  ridx.repeat_interleave(K, dim=0), return_raw=True)
            return model.blend(o, B)["rgb"]

        if nb == 1:
            rgb = block(ray_idx, feat_vol, *maps)
        else:
            rgb = torch.cat([checkpoint(block, r, feat_vol, *maps, use_reentrant=False)
                             for r in ray_idx.chunk(nb, dim=1)], dim=1)
        tar = batch[f"rgb_{i}"]
        if fault == "altered":
            rgb = rgb * 0.98
        if fault == "half_batch":
            rgb, tar = rgb[: B // 2], tar[: B // 2]
        loss = loss + cas.loss_weight[i] * torch.mean((rgb - tar) ** 2)
    return loss


def train_batch(cfg: dict, np_batch: dict) -> dict:
    """A training batch completed as the recipe's entry completes it: the
    combination table of its views and each entry's ``k_best``. The
    recipe's view selection runs on the train split's samples of
    ``train_input_views[1]`` (3) views, whose table holds one combination,
    so every pick is that combination, the batch's first."""
    n_views = np_batch["all_src_inps"].shape[1]
    out = {k: v for k, v in np_batch.items() if k not in ("meta", "combos", "k_best")}
    out["combos"] = view_combinations(n_views, int(cfg["enerf"]["cost_volume_input_views"]))
    out["k_best"] = np.zeros((out["all_src_inps"].shape[0],
                              int(cfg["enerf"]["cas_config"]["k_best"])), np.int32)
    return out


def train_steps(cfg: dict, state_dict: dict, batches: list, device, ray_blocks: int = 8,
                fault: str | None = None) -> dict:
    """Fine-tuning steps of ``cfg`` (the recipe's tree) from ``state_dict``
    over ``batches`` (numpy, one step each), in train mode: the blocked
    loss, the backward, every gradient clipped to [-40, 40], Adam (the
    recipe's lr and eps, betas (0.9, 0.999); the lr stays at its base over
    the first epoch). Returns each step's loss, each parameter's first
    gradient as Adam takes it and its values after the last step."""
    from portbench.reference.plain.enerf import to_tensors

    model = build(cfg, state_dict, device)
    model.train()
    lr, eps = float(cfg["train"]["lr"]), float(cfg["train"]["eps"])
    params = {n: p for n, p in model.named_parameters()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], {}
    for t, np_batch in enumerate(batches, 1):
        batch = to_tensors(train_batch(cfg, np_batch), model.device)
        model.zero_grad(set_to_none=True)
        loss = blocked_loss(model, batch, ray_blocks, fault)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, p in params.items():
                if p.grad is None:
                    continue
                g = p.grad.clamp(-GRAD_CLIP, GRAD_CLIP)
                if t == 1:
                    first[n] = g.clone()
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[n] / (1 - BETAS[1] ** t)).sqrt() + eps
                p.sub_(lr / (1 - BETAS[0] ** t) * m[n] / denom)
    return {"losses": losses, "first_grads": first,
            "params": {n: p.detach().clone() for n, p in params.items()}}
