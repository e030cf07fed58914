"""Image feature extractors (counterpart of
``boostmvsnerfs_tpu/models/feature_net.py``): the FPN ``FeatureNet`` and
the residual U-Net ``ResUNet``, an alternative that no model builds.

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

from .blocks import BatchNorm2d, ConvBnReLU, conv_at
from .sampling import resize_bilinear


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


class ResidualConv(nn.Module):
    """Pre-activation residual block: BN-ReLU-Conv-BN-ReLU-Conv plus a
    Conv-BN skip, stride ``stride`` (JAX ``ResidualConv``, flax names)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.bn_in = BatchNorm2d(cin, eps=1e-5)
        self.conv1 = nn.Conv2d(cin, features, 3, stride=stride, padding=1)
        self.bn_mid = BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.conv_skip = nn.Conv2d(cin, features, 3, stride=stride, padding=1)
        self.bn_skip = BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.bn_in(x).relu())
        h = self.conv2(self.bn_mid(h).relu())
        return h + self.bn_skip(self.conv_skip(x))


class ResUNet(nn.Module):
    """Residual U-Net feature extractor (JAX ``ResUNet``, flax names): a
    16/32/64 residual encoder, a 128 bridge, one 2x transposed-conv decode
    step and a 1x1 conv to one 32-channel map at 1/4 resolution, under the
    FPN's level-dict convention. Computes in the parameters' type."""

    def __init__(self):
        super().__init__()
        self.in_conv1 = nn.Conv2d(3, 16, 3, padding=1)
        self.in_bn = BatchNorm2d(16, eps=1e-5)
        self.in_conv2 = nn.Conv2d(16, 16, 3, padding=1)
        self.in_skip = nn.Conv2d(3, 16, 3, padding=1)
        self.res1 = ResidualConv(16, 32, 2)
        self.res2 = ResidualConv(32, 64, 2)
        self.bridge = ResidualConv(64, 128, 2)
        self.up1 = nn.ConvTranspose2d(128, 128, 2, stride=2)
        self.out_conv = nn.Conv2d(128 + 64, 32, 1)

    def forward(self, x: torch.Tensor) -> dict:
        """x (N, H, W, 3) -> {'level_0': (N, H/4, W/4, 32)}."""
        x = x.permute(0, 3, 1, 2)
        h1 = self.in_conv2(self.in_bn(self.in_conv1(x)).relu()) + self.in_skip(x)
        h3 = self.res2(self.res1(h1))
        up = self.up1(self.bridge(h3))
        out = self.out_conv(torch.cat([up, h3], dim=1))
        return {"level_0": out.permute(0, 2, 3, 1).contiguous()}
