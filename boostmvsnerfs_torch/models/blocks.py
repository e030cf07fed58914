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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from boostmvsnerfs_torch.ops.cuda import conv_dgrad, conv_wgrad


# devices whose float32 training convolutions take the weight-gradient kernel
WGRAD_DEVICES = ("cuda",)
# devices whose float32 3D convolutions take the data-gradient kernel: the
# forward of a transposed one, the input gradient of the others in training
DGRAD_DEVICES = ("cuda",)
# the kernels' operand type (their plain versions compute in the tensors')
KERNEL_DTYPE = torch.float32


def _conv(conv: nn.Module, x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, b, conv.stride, conv.padding, conv.output_padding,
                                  conv.groups, conv.dilation)
    return conv._conv_forward(x, w, b)


class KernelConv(torch.autograd.Function):
    """A convolution module's forward and backward on the port's
    convolution kernels (their plain versions on the CPU): the weight's
    gradient from ``ops/cuda/conv_wgrad``; with ``dgrad`` (``conv_at``'s
    ``routes_dgrad``) a transposed convolution's forward and another
    convolution's input gradient from ``ops/cuda/conv_dgrad``; else the
    module's own forward and PyTorch's ``convolution_backward`` (input
    only). The bias's gradient is the output gradient's sum."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv, dgrad):
        ctx.save_for_backward(x, weight)
        ctx.conv = conv
        ctx.dgrad = dgrad
        if dgrad and conv.transposed:
            return conv_dgrad.conv_transpose_forward(x, weight, bias, conv.stride,
                                                     conv.padding, conv.output_padding)
        return _conv(conv, x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        c = ctx.conv
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if ctx.dgrad and not c.transposed:
                dx = conv_dgrad.conv_data_grad(g, weight, x.shape, c.stride, c.padding)
            else:
                dx = torch.ops.aten.convolution_backward(
                    g, x, weight, None, c.stride, c.padding, c.dilation, c.transposed,
                    c.output_padding, c.groups, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            dw = conv_wgrad.conv_weight_grad(x, g, weight.shape, c.stride, c.padding,
                                            c.transposed)
        if ctx.needs_input_grad[2]:
            db = g.sum([0, *range(2, g.dim())])
        return dx, dw, db, None, None


def _kernel_form(conv: nn.Module, x: torch.Tensor, dtype) -> bool:
    """A convolution at ``KERNEL_DTYPE`` without groups or dilation,
    zero-padded, of a type the kernels compute."""
    return (dtype in (None, KERNEL_DTYPE) and x.dtype == conv.weight.dtype == KERNEL_DTYPE
            and isinstance(conv, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d))
            and conv.groups == 1 and set(conv.dilation) == {1}
            and conv.padding_mode == "zeros" and not isinstance(conv.padding, str))


def routes_wgrad(conv: nn.Module, x: torch.Tensor, dtype=None) -> bool:
    """Whether ``conv_at`` takes ``KernelConv`` for the weight's gradient: a
    float32 convolution whose weight is being trained, on a device of
    ``WGRAD_DEVICES``, of a form the kernel computes (no groups or
    dilation, zero padding)."""
    return (torch.is_grad_enabled() and conv.weight.requires_grad
            and x.device.type in WGRAD_DEVICES and _kernel_form(conv, x, dtype))


def routes_dgrad(conv: nn.Module, x: torch.Tensor, dtype=None) -> bool:
    """Whether the data-gradient form of ``conv`` on ``x`` takes the
    ``conv_dgrad`` kernel (a transposed convolution's forward; another's
    input gradient, inside ``KernelConv``): a float32 3D convolution of the
    kernel's shape (``conv_dgrad.fits``; no groups or dilation), on a
    device of ``DGRAD_DEVICES``."""
    return (x.device.type in DGRAD_DEVICES and _kernel_form(conv, x, dtype)
            and isinstance(conv, (nn.Conv3d, nn.ConvTranspose3d))
            and conv_dgrad.fits(conv.kernel_size, conv.stride, conv.padding))


def conv_at(conv: nn.Module, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``conv(x)`` (an ``nn.Conv2d`` / ``Conv3d`` / ``ConvTranspose3d``)
    with its input, weight and bias cast to ``dtype`` (flax ``nn.Conv(dtype=
    ...)``); ``None`` runs it as it is. Both routes are decided here: a
    float32 convolution in training (``routes_wgrad``) and a float32
    transposed one that ``routes_dgrad`` takes run as ``KernelConv``, with
    the data-gradient route handed to it: the same function, on the
    kernels."""
    wgrad = routes_wgrad(conv, x, dtype)
    dgrad = (wgrad or conv.transposed) and routes_dgrad(conv, x, dtype)
    if wgrad or dgrad:
        return KernelConv.apply(x, conv.weight, conv.bias, conv, dgrad)
    if dtype is None:
        return conv(x)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    return _conv(conv, x.to(dtype), w, b)


class _FlaxStats:
    """Train-mode BatchNorm with flax ``nn.BatchNorm(momentum=0.9)``'s
    running statistics: the batch's *biased* variance goes into
    ``running_var`` (torch's own BatchNorm puts in the unbiased one, n/(n-1)
    larger, as the original PyTorch code does). Normalisation and the eval
    mode are torch's. Momentum 0.1 = flax's 0.9 on the old value. A bf16
    input is normalised in float32 and the output rounded to bf16, as flax's
    ``BatchNorm(dtype=bfloat16)`` does (float32 statistics and arithmetic,
    the result cast to ``dtype``).

    ``sync_group`` (set by ``parallel.mesh.sync_batchnorm``): in train mode
    the statistics are those of the whole batch that the group's ranks
    hold together, the SyncBatchNorm of the reference and what GSPMD gives
    JAX. Each rank's count, mean and sum of squared deviations are
    gathered (differentiably: the backward sums the ranks' gradients) and
    combined; the running statistics take the global mean and biased
    variance."""

    sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._forward(x.float()).to(torch.bfloat16)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.sync_group is not None and dist.get_world_size(self.sync_group) > 1:
            return self._synced(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        from boostmvsnerfs_torch.parallel.mesh import all_gather

        dims = [0, *range(2, x.dim())]
        n = x.numel() // x.shape[1]
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        count = torch.full_like(mean[:1], float(n))
        per_rank = all_gather(torch.cat([count, mean, var * n])[None], self.sync_group)
        counts, means, m2s = per_rank[:, :1], per_rank[:, 1:1 + mean.numel()], \
            per_rank[:, 1 + mean.numel():]
        total = counts.sum()
        g_mean = (counts * means).sum(0) / total
        g_var = (m2s + counts * (means - g_mean) ** 2).sum(0) / total
        with torch.no_grad():
            self.running_mean.lerp_(g_mean, self.momentum)
            self.running_var.lerp_(g_var, self.momentum)
            self.num_batches_tracked += 1
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(g_var + self.eps) * self.weight
        return (x - g_mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)


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
