"""3D U-Nets regularising plane-sweep cost volumes (counterpart of
``boostmvsnerfs_tpu/models/cost_reg_net.py``): ``CostRegNet`` (3 down /
3 up, fine levels) and ``MinCostRegNet`` (2 down / 2 up, coarse level).
Each maps a (B, D, H, W, C) volume to an 8-channel feature volume
(B, D, H, W, 8) and depth logits (B, D, H, W). With ``dtype`` bf16 every
convolution and batch norm computes in bf16 (``models/blocks.py``), as the
JAX modules' ``dtype``, and both outputs come back in float32. The
``interp_upsample`` variant of the JAX module has no counterpart yet.
"""

from __future__ import annotations

import torch
from torch import nn

from boostmvsnerfs_torch.models.blocks import ConvBnReLU, DeconvBn, conv_at


def _cbr3(cin: int, cout: int, stride: int = 1, dtype=None) -> ConvBnReLU:
    return ConvBnReLU(cin, cout, 3, stride, dims=3, dtype=dtype)


def _heads(x: torch.Tensor, feat_conv: nn.Module, depth_conv: nn.Module, dtype):
    feat, depth = conv_at(feat_conv[0], x, dtype), conv_at(depth_conv[0], x, dtype)[:, 0]
    if dtype is not None:
        feat, depth = feat.float(), depth.float()
    return feat.permute(0, 2, 3, 4, 1).contiguous(), depth


class CostRegNet(nn.Module):
    def __init__(self, cin: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = _cbr3(cin, 8, 1, dtype)
        self.conv1 = _cbr3(8, 16, 2, dtype)
        self.conv2 = _cbr3(16, 16, 1, dtype)
        self.conv3 = _cbr3(16, 32, 2, dtype)
        self.conv4 = _cbr3(32, 32, 1, dtype)
        self.conv5 = _cbr3(32, 64, 2, dtype)
        self.conv6 = _cbr3(64, 64, 1, dtype)
        self.conv7 = DeconvBn(64, 32, dtype)
        self.conv9 = DeconvBn(32, 16, dtype)
        self.conv11 = DeconvBn(16, 8, dtype)
        self.feat_conv = nn.Sequential(nn.Conv3d(8, 8, 3, padding=1, bias=False))
        self.depth_conv = nn.Sequential(nn.Conv3d(8, 1, 3, padding=1, bias=False))

    def forward(self, x: torch.Tensor):
        conv0 = self.conv0(x.permute(0, 4, 1, 2, 3))
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return _heads(x, self.feat_conv, self.depth_conv, self.dtype)


class MinCostRegNet(nn.Module):
    def __init__(self, cin: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = _cbr3(cin, 8, 1, dtype)
        self.conv1 = _cbr3(8, 16, 2, dtype)
        self.conv2 = _cbr3(16, 16, 1, dtype)
        self.conv3 = _cbr3(16, 32, 2, dtype)
        self.conv4 = _cbr3(32, 32, 1, dtype)
        self.conv9 = DeconvBn(32, 16, dtype)
        self.conv11 = DeconvBn(16, 8, dtype)
        self.feat_conv = nn.Sequential(nn.Conv3d(8, 8, 3, padding=1, bias=False))
        self.depth_conv = nn.Sequential(nn.Conv3d(8, 1, 3, padding=1, bias=False))

    def forward(self, x: torch.Tensor):
        conv0 = self.conv0(x.permute(0, 4, 1, 2, 3))
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = conv2 + self.conv9(conv4)
        x = conv0 + self.conv11(x)
        return _heads(x, self.feat_conv, self.depth_conv, self.dtype)
