"""Kernel 1: fused plane-sweep warp + variance cost volume.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/warp_variance.py::
fused_warp_variance``; the CUDA source is ``csrc/warp_variance.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from boostmvsnerfs_torch.ops import cost_volume
from boostmvsnerfs_torch.ops.cuda import _build

NAME = "warp_variance"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def warp_variance_plain(
    src_feats: torch.Tensor, proj_mats: torch.Tensor, depth_values: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: ``cost_volume.variance_volume`` batched."""
    return cost_volume.variance_volume(src_feats, proj_mats, depth_values)


def fused_warp_variance(
    src_feats: torch.Tensor,  # (B, S, Hs, Ws, C) float32, C % 4 == 0
    proj_mats: torch.Tensor,  # (B, S, 3, 4)
    depth_values: torch.Tensor,  # (B, D, Ht, Wt) metric depth
) -> torch.Tensor:
    """Variance cost volume over S plane-sweep-warped views, (B, D, Ht, Wt, C),
    with zeros padding. CPU tensors take the plain version."""
    if src_feats.device.type == "cpu":
        return warp_variance_plain(src_feats, proj_mats, depth_values)
    if src_feats.dim() != 5 or depth_values.dim() != 4:
        raise ValueError(f"{NAME}: expected (B,S,Hs,Ws,C) features and (B,D,Ht,Wt) depths")
    B, S, Hs, Ws, C = src_feats.shape
    _, D, Ht, Wt = depth_values.shape
    if tuple(proj_mats.shape) != (B, S, 3, 4) or depth_values.shape[0] != B:
        raise ValueError(
            f"{NAME}: shapes {tuple(src_feats.shape)}, {tuple(proj_mats.shape)}, "
            f"{tuple(depth_values.shape)} do not agree"
        )
    if C % 4:
        raise ValueError(f"{NAME}: channels must be a multiple of 4, got {C}")
    dev = src_feats.device
    _build.check_inputs(NAME, dev, src_feats=src_feats, proj_mats=proj_mats,
                        depth_values=depth_values)
    out = torch.empty((B, D, Ht, Wt, C), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "warp_variance_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(src_feats.data_ptr(), proj_mats.data_ptr(), depth_values.data_ptr(),
                out.data_ptr(), B, S, Hs, Ws, C, D, Ht, Wt, _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
