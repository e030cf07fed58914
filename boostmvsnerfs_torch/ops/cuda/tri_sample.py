"""Kernel 6: trilinear sampling of a channels-last volume, zeros padding.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/tri_sample.py::
fused_tri_sample``; the CUDA source is ``csrc/tri_sample.cu``. The TPU
kernel takes row-banded (B, R, T) coordinate planes and (y, z) windows; a
direct gather needs neither, so here the samples are flat (B, P, 3).
"""

from __future__ import annotations

import ctypes

import torch

from boostmvsnerfs_torch.ops import sampling
from boostmvsnerfs_torch.ops.cuda import _build

NAME = "tri_sample"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p]


def tri_sample_plain(vol: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``sampling.grid_sample_3d`` with zeros
    padding."""
    return sampling.grid_sample_3d(vol, xyz, "zeros")


def fused_tri_sample(
    vol: torch.Tensor,  # (B, D, H, W, C) float32, C a multiple of 4
    xyz: torch.Tensor,  # (B, P, 3) voxel coords (x->W, y->H, z->D), align-corners
) -> torch.Tensor:
    """Trilinear samples (B, P, C); taps outside the volume weigh 0. CPU
    tensors take the plain version."""
    if vol.device.type == "cpu":
        return tri_sample_plain(vol, xyz)
    if vol.dim() != 5 or xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.shape[0] != vol.shape[0]:
        raise ValueError(
            f"{NAME}: expected vol (B,D,H,W,C) and xyz (B,P,3); got "
            f"{tuple(vol.shape)}, {tuple(xyz.shape)}"
        )
    B, D, H, W, C = vol.shape
    if C % 4:
        raise ValueError(f"{NAME}: channels must be a multiple of 4, got {C}")
    P = xyz.shape[1]
    dev = vol.device
    _build.check_inputs(NAME, dev, vol=vol, xyz=xyz)
    out = torch.empty((B, P, C), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "tri_sample_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(vol.data_ptr(), xyz.data_ptr(), out.data_ptr(), B, D, H, W, C, P,
                _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
