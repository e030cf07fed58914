"""Kernels 3 and 4: bilinear sampling of V maps at per-sample coordinates,
and its backward.

Counterparts of ``boostmvsnerfs_tpu/ops/pallas/img_sample.py::
fused_row_sample`` (CUDA source ``csrc/img_sample.cu``) and of
``_row_sample_bwd_impl`` (``csrc/img_sample_bwd.cu``), joined as in JAX's
``fused_row_sample_diff``. The TPU kernels take row-banded (V, R, T)
coordinates; a direct gather needs no rows, so here the samples are flat
(V, P).
"""

from __future__ import annotations

import ctypes

import torch

from boostmvsnerfs_torch.ops import sampling
from boostmvsnerfs_torch.ops.cuda import _build

NAME = "img_sample"
BWD_NAME = "img_sample_bwd"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]
_MODES = ("zeros", "border")


def row_sample_plain(
    imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """The plain PyTorch version: ``sampling.grid_sample_2d`` per view."""
    return sampling.grid_sample_2d(imgs, torch.stack([x, y], dim=-1), padding_mode)


def _check_shapes(name, imgs, x, y, padding_mode):
    if padding_mode not in _MODES:
        raise ValueError(f"{name}: padding_mode must be one of {_MODES}")
    if imgs.dim() != 4 or x.dim() != 2 or x.shape != y.shape or x.shape[0] != imgs.shape[0]:
        raise ValueError(
            f"{name}: expected imgs (V,H,W,C) and x, y (V,P); got "
            f"{tuple(imgs.shape)}, {tuple(x.shape)}, {tuple(y.shape)}"
        )


def fused_row_sample(
    imgs: torch.Tensor,  # (V, H, W, C) float32
    x: torch.Tensor,  # (V, P) source x per sample
    y: torch.Tensor,  # (V, P)
    padding_mode: str = "border",
) -> torch.Tensor:
    """Bilinear samples (V, P, C), align-corners pixel coordinates, border or
    zeros padding. CPU tensors take the plain version."""
    if padding_mode not in _MODES:
        raise ValueError(f"{NAME}: padding_mode must be one of {_MODES}")
    if imgs.device.type == "cpu":
        return row_sample_plain(imgs, x, y, padding_mode)
    _check_shapes(NAME, imgs, x, y, padding_mode)
    V, H, W, C = imgs.shape
    P = x.shape[1]
    dev = imgs.device
    _build.check_inputs(NAME, dev, imgs=imgs, x=x, y=y)
    out = torch.empty((V, P, C), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "img_sample_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(imgs.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), V, H, W, C, P,
                int(padding_mode == "border"), _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out


def row_sample_bwd_plain(
    imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: (d imgs, d x, d y) for the
    cotangent ``g`` (V, P, C), with the Pallas backward's conventions
    (``sampling.grid_sample_2d_bwd``)."""
    return sampling.grid_sample_2d_bwd(imgs, x, y, g, padding_mode)


def row_sample_bwd(
    imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    padding_mode: str = "border",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d imgs, d x, d y) of ``fused_row_sample`` for the cotangent ``g``
    (V, P, C). CPU tensors take the plain version."""
    _check_shapes(BWD_NAME, imgs, x, y, padding_mode)
    if imgs.device.type == "cpu":
        return row_sample_bwd_plain(imgs, x, y, g, padding_mode)
    V, H, W, C = imgs.shape
    P = x.shape[1]
    if tuple(g.shape) != (V, P, C):
        raise ValueError(f"{BWD_NAME}: cotangent {tuple(g.shape)} is not (V, P, C)")
    dev = imgs.device
    _build.check_inputs(BWD_NAME, dev, imgs=imgs, x=x, y=y, g=g)
    d_imgs = torch.zeros_like(imgs)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    fn = _build.kernel_function(BWD_NAME, "img_sample_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(imgs.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(), d_imgs.data_ptr(),
                dx.data_ptr(), dy.data_ptr(), V, H, W, C, P, int(padding_mode == "border"),
                _build.stream_ptr(dev))
    _build.check(BWD_NAME, rc)
    _build.count_launch(BWD_NAME)
    return d_imgs, dx, dy


class _RowSampleDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, x, y, padding_mode):
        ctx.save_for_backward(imgs, x, y)
        ctx.padding_mode = padding_mode
        return fused_row_sample(imgs, x, y, padding_mode)

    @staticmethod
    def backward(ctx, g):
        imgs, x, y = ctx.saved_tensors
        d_imgs, dx, dy = row_sample_bwd(imgs, x, y, g.contiguous(), ctx.padding_mode)
        return d_imgs, dx, dy, None


def fused_row_sample_diff(
    imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Differentiable ``fused_row_sample`` (the training path): the forward
    kernel, and the backward kernel for the gradients of the maps and of
    the coordinates (through which they reach the caller's depth)."""
    return _RowSampleDiff.apply(imgs, x, y, padding_mode)
