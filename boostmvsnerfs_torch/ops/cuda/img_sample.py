"""Kernel 2: bilinear sampling of V maps at per-sample coordinates.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/img_sample.py::
fused_row_sample``; the CUDA source is ``csrc/img_sample.cu``. The TPU
kernel takes row-banded (V, R, T) coordinates; a direct gather needs no
rows, so here the samples are flat (V, P).
"""

from __future__ import annotations

import ctypes

import torch

from boostmvsnerfs_torch.ops import sampling
from boostmvsnerfs_torch.ops.cuda import _build

NAME = "img_sample"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]
_MODES = ("zeros", "border")


def row_sample_plain(
    imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """The plain PyTorch version: ``sampling.grid_sample_2d`` per view."""
    return sampling.grid_sample_2d(imgs, torch.stack([x, y], dim=-1), padding_mode)


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
    if imgs.dim() != 4 or x.dim() != 2 or x.shape != y.shape or x.shape[0] != imgs.shape[0]:
        raise ValueError(
            f"{NAME}: expected imgs (V,H,W,C) and x, y (V,P); got "
            f"{tuple(imgs.shape)}, {tuple(x.shape)}, {tuple(y.shape)}"
        )
    V, H, W, C = imgs.shape
    P = x.shape[1]
    dev = imgs.device
    _build.check_inputs(NAME, dev, imgs=imgs, x=x, y=y)
    out = torch.empty((V, P, C), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "img_sample_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(imgs.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), V, H, W, C, P,
                int(padding_mode == "border"), _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
