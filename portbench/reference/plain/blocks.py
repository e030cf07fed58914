"""Shared conv building blocks (counterpart of ``boostmvsnerfs_tpu/models/blocks.py``).

Modules here work in PyTorch's channels-first layout (NCHW / NCDHW); the
networks that use them convert at their public boundary. ``dtype`` is the
computation type of the JAX blocks' ``dtype`` (flax's, not its
``param_dtype``): at ``torch.bfloat16`` a convolution takes its input and
weights rounded to bf16 and returns bf16, and a BatchNorm computes its
statistics and normalisation in float32 from its bf16 input and rounds its
output to bf16; parameters and statistics stay float32. ``None`` computes
in the parameters' type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv_at(conv: nn.Module, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``conv(x)`` (an ``nn.Conv2d`` / ``Conv3d`` / ``ConvTranspose3d``)
    with its input, weight and bias cast to ``dtype`` (flax ``nn.Conv(dtype=
    ...)``); ``None`` runs it as it is."""
    if dtype is None:
        return conv(x)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x.to(dtype), w, b, conv.stride, conv.padding,
                                  conv.output_padding, conv.groups, conv.dilation)
    return conv._conv_forward(x.to(dtype), w, b)


class _FlaxStats:
    """Train-mode BatchNorm with flax ``nn.BatchNorm(momentum=0.9)``'s
    running statistics: the batch's *biased* variance goes into
    ``running_var`` (torch's own BatchNorm puts in the unbiased one, n/(n-1)
    larger, as the original PyTorch code does). Normalisation and the eval
    mode are torch's. Momentum 0.1 = flax's 0.9 on the old value. A bf16
    input is normalised in float32 and the output rounded to bf16, as flax's
    ``BatchNorm(dtype=bfloat16)`` does (float32 statistics and arithmetic,
    the result cast to ``dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._forward(x.float()).to(torch.bfloat16)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStats, nn.BatchNorm3d):
    pass


class ConvBnReLU(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-5) + ReLU, 2D or 3D, with symmetric
    ``k // 2`` padding. Parameter names ``conv.*`` / ``bn.*`` follow the
    reference checkpoints. Computes at ``dtype`` (module docstring)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, dims: int = 2,
                 dtype=None):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        bn = BatchNorm2d if dims == 2 else BatchNorm3d
        self.conv = conv(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.bn = bn(cout, eps=1e-5)
        self.dtype = dtype

    def conv_bn(self, x):
        return self.bn(conv_at(self.conv, x, self.dtype))

    def forward(self, x):
        return self.conv_bn(x).relu()


class DeconvBn(nn.Sequential):
    """ConvTranspose3d(k3, s2, p1, op1, no bias) + BatchNorm3d: an exact 2x
    upsampling (flax ``ConvTranspose(padding ((1, 2),)*3,
    transpose_kernel=True)``). Names ``0.*`` / ``1.*`` as in the reference.
    Computes at ``dtype`` (module docstring)."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__(
            nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1, output_padding=1, bias=False),
            BatchNorm3d(cout, eps=1e-5),
        )
        self.dtype = dtype

    def forward(self, x):
        return self[1](conv_at(self[0], x, self.dtype))


class ConvBnLeaky(ConvBnReLU):
    """``ConvBnReLU`` with leaky-ReLU(0.01) after the BatchNorm: the
    reference's InPlaceABN blocks of MVSNeRF (its default activation)."""

    def forward(self, x):
        return nn.functional.leaky_relu(self.conv_bn(x), 0.01)


class DeconvBnLeaky(DeconvBn):
    """``DeconvBn`` followed by leaky-ReLU(0.01)."""

    def forward(self, x):
        return nn.functional.leaky_relu(super().forward(x), 0.01)
