"""FPN image feature extractor (counterpart of
``boostmvsnerfs_tpu/models/feature_net.py::FeatureNet``).

Three encoder stages (8/16/32 ch at 1/1, 1/2, 1/4 resolution) with
top-down lateral merges giving 32 ch @ 1/4, 16 ch @ 1/2 and 8 ch @ 1/1.
This is the plain form: ``lat0``, upsample-add, ``smooth0``. (The JAX
module composes ``lat0`` into ``smooth0`` only to save TPU memory; the two
are equal by linearity.)
"""

from __future__ import annotations

import torch
from torch import nn

from boostmvsnerfs_torch.models.blocks import ConvBnReLU
from boostmvsnerfs_torch.ops.sampling import resize_bilinear


def _up_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Align-corners bilinear upsample of NCHW ``x`` to ``y``'s size, plus ``y``."""
    up = resize_bilinear(x.permute(0, 2, 3, 1), y.shape[-2], y.shape[-1])
    return up.permute(0, 3, 1, 2) + y


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8, 3), ConvBnReLU(8, 8, 3))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2), ConvBnReLU(16, 16, 3))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2), ConvBnReLU(32, 32, 3))
        self.toplayer = nn.Conv2d(32, 32, 1)
        self.lat1 = nn.Conv2d(16, 32, 1)
        self.lat0 = nn.Conv2d(8, 32, 1)
        self.smooth1 = nn.Conv2d(32, 16, 3, padding=1)
        self.smooth0 = nn.Conv2d(32, 8, 3, padding=1)

    def forward(self, x: torch.Tensor) -> dict:
        """x (N, H, W, 3) -> {'level_0': (N, H/4, W/4, 32),
        'level_1': (N, H/2, W/2, 16), 'level_2': (N, H, W, 8)}; level_0 is
        the coarsest, as the cascade consumes them."""
        conv0 = self.conv0(x.permute(0, 3, 1, 2))
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        feat2 = self.toplayer(conv2)
        feat1 = _up_add(feat2, self.lat1(conv1))
        feat0 = _up_add(feat1, self.lat0(conv0))
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
        return {
            "level_0": nhwc(feat2),
            "level_1": nhwc(self.smooth1(feat1)),
            "level_2": nhwc(self.smooth0(feat0)),
        }
