"""The plain reference of the BoostMVSNeRF family: the eval frame, in
blocks of raster rows.

The model is ``plain/boost_mvsnerf.py``'s, built from a configuration tree
and given the benchmark's weights; its kernels are plain versions at the
card's precisions (``plain/kernels.py``). Every ray is independent of the
others, so the frame renders in blocks of ``ROW_BLOCK`` raster rows after
one ``frame_volume``, which keeps the plain lookups and MLP inside the
card's memory; the blocks change no value.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain.boost_mvsnerf import BoostMVSNeRF
from portbench.reference.plain.enerf import to_tensors
from portbench.reference.plain.mvsnerf import MVSNeRFConfig

__all__ = ["build", "frame"]

ROW_BLOCK = 32


def build(cfg: dict, state_dict: dict, device) -> BoostMVSNeRF:
    """The reference model of ``cfg`` (the whole configuration tree) on
    ``device``, in eval mode, holding ``state_dict``."""
    model = BoostMVSNeRF(MVSNeRFConfig.from_cfg(cfg), device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


@torch.no_grad()
def frame(model: BoostMVSNeRF, batch: dict) -> dict:
    """The eval frame's outputs (``*_level0``) of a batch (numpy arrays or
    tensors) that carries ``combos`` and ``k_best``; its rays are every
    pixel of the target raster, in raster order."""
    batch = to_tensors(batch, model.device)
    sub, volume, near, far = model.frame_volume(batch)
    W = batch["all_src_inps"].shape[3]
    outs = [model.render_rays(sub, volume, ids, near, far)
            for ids in batch["ray_idx_0"].split(ROW_BLOCK * W, dim=1)]
    return {f"{k}_level0": torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}


def coverage(model: BoostMVSNeRF, batch: dict, combos: np.ndarray) -> np.ndarray:
    """The coverage masks of every combination, (n_combos, B, H, W)."""
    return model.forward_view_selection(batch, combos).cpu().numpy()
