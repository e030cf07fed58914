"""Kernels 1 and 2: fused plane-sweep warp + variance cost volume, and its
backward.

Counterparts of ``boostmvsnerfs_tpu/ops/pallas/warp_variance.py::
fused_warp_variance`` (CUDA source ``csrc/warp_variance.cu``) and of
``_warp_variance_bwd`` (``csrc/warp_variance_bwd.cu``), joined as in JAX's
``fused_warp_variance_diff``: an autograd Function whose forward is the
first kernel and whose backward is the second. Both walk the plane sweep in
chunks of a target-pixel tile x a run of neighbouring planes
(``sweep_tile``; ``csrc/plane_sweep.cuh``).

As in JAX, ``compute_dtype`` sets the forward's operands: bfloat16 (JAX's
default, the eval path's ``warp_dtype``) rounds the features and the tap
weights to bf16, with float32 products, sums and variance; float32 runs
the f32 instance. The training forward and the backward are float32, as
JAX's ``fused_warp_variance_diff`` is.
"""

from __future__ import annotations

import ctypes

import torch

from boostmvsnerfs_torch.ops import cost_volume, sampling
from boostmvsnerfs_torch.ops.cuda import _build
from boostmvsnerfs_torch.ops.cuda._tensor_cores import check_compute_dtype

NAME = "warp_variance"
BWD_NAME = "warp_variance_bwd"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
# the kernels' threads per block (csrc/warp_variance*.cu kThreads): one
# per (pixel, 4 channels) of a tile
THREADS = 256
# the most planes in a run (csrc/warp_variance*.cu kPlanes)
PLANES_PER_RUN = 4


def sweep_tile(C: int, D: int) -> tuple[int, int, int]:
    """The kernels' chunk: (TX, TY, ND), a tile of TX x TY target pixels
    (powers of two, the tile as square as they allow), at most one (pixel,
    4 channels) per thread, by a run of ND neighbouring planes."""
    pixels = max(1, THREADS // (C // 4))
    tx = 1 << (pixels.bit_length() // 2)
    return tx, 1 << ((pixels // tx).bit_length() - 1), min(D, PLANES_PER_RUN)


def warp_variance_plain(
    src_feats: torch.Tensor, proj_mats: torch.Tensor, depth_values: torch.Tensor,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """The plain PyTorch version: ``cost_volume.variance_volume`` batched,
    at ``compute_dtype`` (bfloat16 rounds the features and tap weights)."""
    check_compute_dtype(NAME, compute_dtype)
    return cost_volume.variance_volume(src_feats, proj_mats, depth_values, compute_dtype)


def _check_shapes(name, src_feats, proj_mats, depth_values):
    if src_feats.dim() != 5 or depth_values.dim() != 4:
        raise ValueError(f"{name}: expected (B,S,Hs,Ws,C) features and (B,D,Ht,Wt) depths")
    B, S, Hs, Ws, C = src_feats.shape
    if tuple(proj_mats.shape) != (B, S, 3, 4) or depth_values.shape[0] != B:
        raise ValueError(
            f"{name}: shapes {tuple(src_feats.shape)}, {tuple(proj_mats.shape)}, "
            f"{tuple(depth_values.shape)} do not agree"
        )
    if C % 4:
        raise ValueError(f"{name}: channels must be a multiple of 4, got {C}")


def fused_warp_variance(
    src_feats: torch.Tensor,  # (B, S, Hs, Ws, C) float32, C % 4 == 0
    proj_mats: torch.Tensor,  # (B, S, 3, 4)
    depth_values: torch.Tensor,  # (B, D, Ht, Wt) metric depth
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Variance cost volume over S plane-sweep-warped views, (B, D, Ht, Wt, C),
    with zeros padding. On the card ``compute_dtype`` picks the instance:
    bfloat16 (the default, JAX's) rounds the features and tap weights to
    bf16 in the kernel, float32 takes them as they are. CPU tensors take
    the plain version in float32, as the JAX package takes its XLA path off
    the TPU."""
    check_compute_dtype(NAME, compute_dtype)
    if src_feats.device.type == "cpu":
        return warp_variance_plain(src_feats, proj_mats, depth_values)
    _check_shapes(NAME, src_feats, proj_mats, depth_values)
    B, S, Hs, Ws, C = src_feats.shape
    _, D, Ht, Wt = depth_values.shape
    dev = src_feats.device
    _build.check_inputs(NAME, dev, src_feats=src_feats, proj_mats=proj_mats,
                        depth_values=depth_values)
    out = torch.empty((B, D, Ht, Wt, C), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "warp_variance_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(src_feats.data_ptr(), proj_mats.data_ptr(), depth_values.data_ptr(),
                out.data_ptr(), B, S, Hs, Ws, C, D, Ht, Wt, *sweep_tile(C, D),
                int(compute_dtype == torch.bfloat16), _build.sm_count(dev),
                _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out


def warp_variance_bwd_plain(
    src_feats: torch.Tensor,  # (B, S, Hs, Ws, C)
    proj_mats: torch.Tensor,  # (B, S, 3, 4)
    depth_values: torch.Tensor,  # (B, D, Ht, Wt)
    g: torch.Tensor,  # (B, D, Ht, Wt, C) cotangent of the variance volume
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: (d src_feats, d
    depth_values). Each view's cotangent is g * (2/S) * (w_s - mean); it
    goes to the features through the transposed bilinear weights and to the
    depth through the coordinates (``sampling.grid_sample_2d_bwd``'s
    conventions), chained through x = sx / max(sz, 1e-6), where sx, sy, sz
    are linear in 1/depth and a clamped sz carries no gradient."""
    B, S, Hs, Ws, C = src_feats.shape
    _, D, Ht, Wt = depth_values.shape
    coords, warped = [], []
    for s in range(S):
        sx, sy, sz_raw = cost_volume.projected_rows(proj_mats[:, s], depth_values)
        sz = sz_raw.clamp_min(1e-6)
        x, y = (sx / sz).reshape(B, -1), (sy / sz).reshape(B, -1)
        coords.append((x, y, sz.reshape(B, -1), (sz_raw > 1e-6).reshape(B, -1)))
        warped.append(sampling.grid_sample_2d(src_feats[:, s], torch.stack([x, y], -1), "zeros"))
    mean = sum(warped) / S
    g = g.reshape(B, -1, C)
    inv_d = 1.0 / depth_values.reshape(B, -1)
    d_feats, g_invd = [], 0.0
    for s, ((x, y, sz, live), w) in enumerate(zip(coords, warped)):
        gs = g * (2.0 / S) * (w - mean)
        d_img, gx, gy = sampling.grid_sample_2d_bwd(src_feats[:, s], x, y, gs, "zeros")
        d_feats.append(d_img)
        P = proj_mats[:, s]
        pz = torch.where(live, P[:, 2:3, 3], 0.0)
        g_invd = (g_invd + gx * (P[:, 0:1, 3] - x * pz) / sz
                  + gy * (P[:, 1:2, 3] - y * pz) / sz)
    d_depth = g_invd * (-inv_d * inv_d)
    return torch.stack(d_feats, 1), d_depth.reshape(B, D, Ht, Wt)


def warp_variance_bwd(
    src_feats: torch.Tensor, proj_mats: torch.Tensor, depth_values: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d src_feats, d depth_values) of ``fused_warp_variance`` for the
    cotangent ``g`` (B, D, Ht, Wt, C). CPU tensors take the plain version."""
    if src_feats.device.type == "cpu":
        return warp_variance_bwd_plain(src_feats, proj_mats, depth_values, g)
    _check_shapes(BWD_NAME, src_feats, proj_mats, depth_values)
    B, S, Hs, Ws, C = src_feats.shape
    _, D, Ht, Wt = depth_values.shape
    if tuple(g.shape) != (B, D, Ht, Wt, C):
        raise ValueError(f"{BWD_NAME}: cotangent {tuple(g.shape)} is not the volume's shape")
    dev = src_feats.device
    _build.check_inputs(BWD_NAME, dev, src_feats=src_feats, proj_mats=proj_mats,
                        depth_values=depth_values, g=g)
    d_feats = torch.zeros_like(src_feats)
    d_depth = torch.zeros_like(depth_values)
    fn = _build.kernel_function(BWD_NAME, "warp_variance_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(src_feats.data_ptr(), proj_mats.data_ptr(), depth_values.data_ptr(), g.data_ptr(),
                d_feats.data_ptr(), d_depth.data_ptr(), B, S, Hs, Ws, C, D, Ht, Wt,
                *sweep_tile(C, D), _build.sm_count(dev), _build.stream_ptr(dev))
    _build.check(BWD_NAME, rc)
    _build.count_launch(BWD_NAME)
    return d_feats, d_depth


class _WarpVarianceDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src_feats, proj_mats, depth_values):
        ctx.save_for_backward(src_feats, proj_mats, depth_values)
        return fused_warp_variance(src_feats, proj_mats, depth_values, torch.float32)

    @staticmethod
    def backward(ctx, g):
        src_feats, proj_mats, depth_values = ctx.saved_tensors
        d_feats, d_depth = warp_variance_bwd(src_feats, proj_mats, depth_values, g.contiguous())
        # the projection matrices get no cotangent, as in the JAX VJP
        return d_feats, None, d_depth


def fused_warp_variance_diff(
    src_feats: torch.Tensor, proj_mats: torch.Tensor, depth_values: torch.Tensor
) -> torch.Tensor:
    """Differentiable ``fused_warp_variance`` (the training path): the
    forward kernel's f32 instance, and the backward kernel for the
    gradients of ``src_feats`` and ``depth_values``."""
    return _WarpVarianceDiff.apply(src_feats, proj_mats, depth_values)
