"""ENeRF IBR head: per-sample radiance from voxel + multi-view image features
(counterpart of ``boostmvsnerfs_tpu/models/nerf_head.py``).

The layers are plain ``nn.Linear``s under the reference checkpoint names
(``agg.view_fc.0``, ``agg.global_fc.0``, ``agg.agg_w_fc.0``, ``agg.fc.0``,
``lr0.0``, ``sigma.0``, ``color.0``, ``color.2``). ``forward`` runs the
head through ``kernels.fused_nerf_head``, the plain math with bf16
operands and float32 sums (the kernel's contract); in train mode, the
plain math in float32. ``use_vox_feat=False`` is the older
image-feature-only head of the layered composite variant: lr0 reads the
pooled image feature alone and the voxel features are not an input.
"""

from __future__ import annotations

import torch
from torch import nn

from .kernels import fused_nerf_head, nerf_head_plain


class Agg(nn.Module):
    """View aggregation: view-direction conditioning, mean/var over views,
    softmax-weighted pooling to a 16-d feature."""

    def __init__(self, feat_ch: int, viewdir_agg: bool = True):
        super().__init__()
        if viewdir_agg:
            self.view_fc = nn.Sequential(nn.Linear(4, feat_ch), nn.ReLU())
        self.global_fc = nn.Sequential(nn.Linear(feat_ch * 3, 32), nn.ReLU())
        self.agg_w_fc = nn.Sequential(nn.Linear(32, 1), nn.ReLU())
        self.fc = nn.Sequential(nn.Linear(32, 16), nn.ReLU())


class NeRFHead(nn.Module):
    """Sigma from a softplus head on [voxel feature, pooled image feature];
    color as a softmax blend of the source views' RGB (the last 3 of the
    ``feat_ch`` per-view channels). Without ``use_vox_feat`` sigma comes
    from the pooled image feature alone. Built in eval mode, as the models
    are."""

    def __init__(self, feat_ch: int, hid_n: int = 64, viewdir_agg: bool = True,
                 use_vox_feat: bool = True):
        super().__init__()
        self.use_vox_feat = use_vox_feat
        in_lr0 = 8 + 16 if use_vox_feat else 16
        self.agg = Agg(feat_ch, viewdir_agg)
        self.lr0 = nn.Sequential(nn.Linear(in_lr0, hid_n), nn.ReLU())
        self.sigma = nn.Sequential(nn.Linear(hid_n, 1), nn.Softplus())
        self.color = nn.Sequential(
            nn.Linear(hid_n + in_lr0 + feat_ch + 4, hid_n), nn.ReLU(),
            nn.Linear(hid_n, 1), nn.ReLU(),
        )
        self.eval()

    def head_params(self) -> dict:
        """Layer name -> (weight, bias), the form the head kernel takes."""
        layers = {
            "global_fc": self.agg.global_fc[0],
            "agg_w_fc": self.agg.agg_w_fc[0],
            "fc": self.agg.fc[0],
            "lr0": self.lr0[0],
            "sigma": self.sigma[0],
            "color0": self.color[0],
            "color1": self.color[2],
        }
        if hasattr(self.agg, "view_fc"):
            layers["view_fc"] = self.agg.view_fc[0]
        return {k: (m.weight, m.bias) for k, m in layers.items()}

    def forward(self, vox: torch.Tensor | None, feat: torch.Tensor,
                dirs: torch.Tensor) -> torch.Tensor:
        """vox (B, P, 8) (ignored without ``use_vox_feat``: pass None), feat
        (B, S, P, feat_ch), dirs (B, S, P, 4) -> raw (rgb, sigma) (B, P, 4).
        In train mode the head is the plain PyTorch math under autograd, as
        the JAX package runs its XLA head when training (the head kernel has
        no backward there either)."""
        if not self.use_vox_feat:
            vox = None
        if self.training:
            return nerf_head_plain(self.head_params(), vox, feat, dirs)
        return fused_nerf_head(self.head_params(), vox, feat, dirs)
