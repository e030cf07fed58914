"""The data gradient of a float32 3D convolution (CUDA source
``csrc/conv_dgrad.cu``).

No TPU kernel: the JAX package left the convolutions to XLA. One operation
with two uses, which ``models/blocks.conv_at`` sends here: the input
gradient of a ``Conv3d`` in training, and the forward of a
``ConvTranspose3d`` (its input read as the output's gradient of the adjoint
convolution, whose weight has the same layout). Kernel 3, padding 1, stride
1 or 2, no groups or dilation.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from boostmvsnerfs_torch.ops.cuda import _build

NAME = "conv_dgrad"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def conv_dgrad_plain(g: torch.Tensor, weight: torch.Tensor, x_shape, stride,
                     padding) -> torch.Tensor:
    """The plain PyTorch version: per tap, the output's gradient against
    the tap's weights, added into the zero-padded input at the positions
    the tap reads; the padding cut off."""
    N, _, *O = g.shape
    C, ks, S = weight.shape[1], weight.shape[2:], x_shape[2:]
    size = [max(i + 2 * p, s * (o - 1) + k) for i, p, s, o, k in zip(S, padding, stride, O, ks)]
    out = g.new_zeros(N, C, *size)
    for tap in itertools.product(*(range(k) for k in ks)):
        out[(slice(None), slice(None),
             *(slice(t, t + s * (o - 1) + 1, s) for t, s, o in zip(tap, stride, O)))] += \
            torch.einsum("nm...,mc->nc...", g, weight[(slice(None), slice(None), *tap)])
    return out[(slice(None), slice(None), *(slice(p, p + i) for p, i in zip(padding, S)))]


def fits(kernel_size, stride, padding) -> bool:
    """The kernel's shape rule: kernel 3, padding 1 and stride 1 or 2 in
    each of the three dimensions (``models/blocks.routes_dgrad`` routes by
    it, ``conv_data_grad`` raises outside it)."""
    return (tuple(kernel_size) == (3, 3, 3) and tuple(padding) == (1, 1, 1)
            and set(stride) <= {1, 2})


def _check(g, weight, x_shape, stride, padding) -> None:
    if g.dim() != 5 or weight.dim() != 5 or len(x_shape) != 5:
        raise ValueError(f"{NAME}: g {tuple(g.shape)}, weight {tuple(weight.shape)} and input "
                         f"{tuple(x_shape)} are not one 3D convolution")
    M, C, *ks = weight.shape
    if g.shape[1] != M or x_shape[1] != C or g.shape[0] != x_shape[0]:
        raise ValueError(f"{NAME}: g {tuple(g.shape)} and input {tuple(x_shape)} do not fit "
                         f"weight {tuple(weight.shape)}")
    if not fits(ks, stride, padding):
        raise ValueError(f"{NAME}: kernel {tuple(ks)}, padding {tuple(padding)} and stride "
                         f"{tuple(stride)}: the kernel takes kernel 3, padding 1, stride 1 or 2")
    for o, i, s in zip(g.shape[2:], x_shape[2:], stride):
        if o != (i + 2 - 3) // s + 1:
            raise ValueError(f"{NAME}: g {tuple(g.shape)} is not the output of input "
                             f"{tuple(x_shape)} at stride {tuple(stride)}")


def conv_data_grad(g: torch.Tensor, weight: torch.Tensor, x_shape, stride,
                   padding) -> torch.Tensor:
    """The gradient of the input (``x_shape``: N, C, D, H, W) of a 3D
    convolution with ``weight`` (M, C, 3, 3, 3), ``stride`` and
    ``padding``, for its output's gradient ``g`` (N, M, ...); equally the
    forward of a transposed convolution of ``g`` with ``weight`` (its
    output ``x_shape``). CPU tensors take the plain version; CUDA ones the
    kernel, float32 only, which returns an (N, C, D, H, W) view of a
    channels-last tensor."""
    x_shape, stride, padding = tuple(x_shape), tuple(stride), tuple(padding)
    _check(g, weight, x_shape, stride, padding)
    if g.device.type == "cpu":
        return conv_dgrad_plain(g, weight, x_shape, stride, padding)
    dev = g.device
    gc = g.movedim(1, -1).contiguous()  # free when g is channels-last already
    w = weight.contiguous()
    _build.check_inputs(NAME, dev, g=gc, w=w)
    N, C, D, H, W = x_shape
    out = torch.empty((N, D, H, W, C), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "conv_dgrad_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(gc.data_ptr(), w.data_ptr(), out.data_ptr(), N, D, H, W, C, *g.shape[2:],
                g.shape[1], *stride, _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out.movedim(-1, 1)


def conv_transpose_forward(x: torch.Tensor, weight: torch.Tensor, bias, stride, padding,
                           output_padding) -> torch.Tensor:
    """``F.conv_transpose3d(x, weight, bias, stride, padding,
    output_padding)`` for kernel 3, padding 1, stride 1 or 2: the data
    gradient of the adjoint convolution (``conv_data_grad``)."""
    shape = (x.shape[0], weight.shape[1], *((i - 1) * s - 2 * p + 3 + op for i, s, p, op
                                            in zip(x.shape[2:], stride, padding, output_padding)))
    out = conv_data_grad(x, weight, shape, stride, padding)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out
