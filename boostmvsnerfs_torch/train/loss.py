"""Training losses (counterpart of ``boostmvsnerfs_tpu/train/loss.py``).

Reference lib/train/losses/enerf.py: per-cascade-level MSE on rendered rays
weighted by ``loss_weight``, with PSNR statistics, plus a perceptual term
(weight 0.01 * level weight when a level trains on full images) when a
``perceptual_fn`` is given.
"""

from __future__ import annotations

import math

import torch


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def enerf_loss(
    output: dict,
    batch: dict,
    loss_weight: tuple,
    num_levels: int,
    render_if: tuple = (True, True),
    perceptual_fn=None,
    image_hw: tuple | None = None,
    train_img: tuple | None = None,
) -> tuple[torch.Tensor, dict]:
    """Weighted colour loss over cascade levels: (loss, stats).

    ``batch['rgb_{i}']`` is (B, N_i, 3) ground truth at the level's ray
    pixels. ``perceptual_fn(pred_img, tar_img) -> scalar`` is applied when
    given and the level renders a full image of ``image_hw[i]``.
    """
    stats = {}
    loss = torch.zeros(())
    for i in range(num_levels):
        if not render_if[i]:
            continue
        pred = output[f"rgb_level{i}"]
        tar = batch[f"rgb_{i}"]
        color_mse = torch.mean((pred - tar) ** 2)
        stats[f"color_mse_{i}"] = color_mse
        stats[f"psnr_{i}"] = mse2psnr(color_mse)
        loss = loss + loss_weight[i] * color_mse
        if perceptual_fn is not None and image_hw is not None and (
            train_img is None or train_img[i]
        ):
            h, w = image_hw[i]
            p = perceptual_fn(pred.reshape(pred.shape[0], h, w, 3),
                              tar.reshape(tar.shape[0], h, w, 3))
            stats[f"perceptual_loss_{i}"] = p
            loss = loss + 0.01 * loss_weight[i] * p
    stats["loss"] = loss
    return loss, stats
