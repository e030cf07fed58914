"""FPN image feature extractor (counterpart of
``boostmvsnerfs_tpu/models/feature_net.py::FeatureNet``).

Three encoder stages (8/16/32 ch at 1/1, 1/2, 1/4 resolution) with
top-down lateral merges giving 32 ch @ 1/4, 16 ch @ 1/2 and 8 ch @ 1/1.
This is the plain form: ``lat0``, upsample-add, ``smooth0``. (The JAX
module composes ``lat0`` into ``smooth0`` only to save TPU memory; the two
are equal by linearity.) With ``dtype`` bf16 every convolution and
batch norm computes in bf16 (``models/blocks.py``), as the JAX module's
``dtype``, and the outputs come back in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from boostmvsnerfs_torch.models.blocks import ConvBnReLU, conv_at
from boostmvsnerfs_torch.ops.sampling import resize_bilinear


def _up_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Align-corners bilinear upsample of NCHW ``x`` to ``y``'s size, plus ``y``."""
    up = resize_bilinear(x.permute(0, 2, 3, 1), y.shape[-2], y.shape[-1])
    return up.permute(0, 3, 1, 2) + y


class FeatureNet(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        cbr = lambda *a: ConvBnReLU(*a, dtype=dtype)  # noqa: E731
        self.conv0 = nn.Sequential(cbr(3, 8, 3), cbr(8, 8, 3))
        self.conv1 = nn.Sequential(cbr(8, 16, 5, 2), cbr(16, 16, 3))
        self.conv2 = nn.Sequential(cbr(16, 32, 5, 2), cbr(32, 32, 3))
        self.toplayer = nn.Conv2d(32, 32, 1)
        self.lat1 = nn.Conv2d(16, 32, 1)
        self.lat0 = nn.Conv2d(8, 32, 1)
        self.smooth1 = nn.Conv2d(32, 16, 3, padding=1)
        self.smooth0 = nn.Conv2d(32, 8, 3, padding=1)

    def forward(self, x: torch.Tensor) -> dict:
        """x (N, H, W, 3) -> {'level_0': (N, H/4, W/4, 32),
        'level_1': (N, H/2, W/2, 16), 'level_2': (N, H, W, 8)}; level_0 is
        the coarsest, as the cascade consumes them."""
        conv = lambda layer, t: conv_at(layer, t, self.dtype)  # noqa: E731
        conv0 = self.conv0(x.permute(0, 3, 1, 2))
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        feat2 = conv(self.toplayer, conv2)
        feat1 = _up_add(feat2, conv(self.lat1, conv1))
        feat0 = _up_add(feat1, conv(self.lat0, conv0))
        out = {"level_0": feat2, "level_1": conv(self.smooth1, feat1),
               "level_2": conv(self.smooth0, feat0)}
        if self.dtype is not None:
            out = {k: v.float() for k, v in out.items()}
        return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in out.items()}
