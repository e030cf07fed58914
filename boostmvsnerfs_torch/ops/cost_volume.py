"""Plane-sweep cost volumes and cascade depth-hypothesis schedules.

Counterpart of the exact functions of ``boostmvsnerfs_tpu/ops/cost_volume.py``
(the windowed forms there reformulate the same math for the TPU's matrix
unit and have no counterpart here). With ``inverse`` the D hypotheses are
uniform in disparity; ``depth_values`` always hold metric depth.
"""

from __future__ import annotations

import torch

from boostmvsnerfs_torch.ops import sampling


def initial_depth_values(
    near_far: torch.Tensor,  # (B, 2) scene-level [near, far]
    D: int,
    H: int,
    W: int,
    inverse: bool,
) -> torch.Tensor:
    """(B, D, H, W) depth hypotheses for the first cascade level."""
    B = near_far.shape[0]
    t = sampling.linspace(0.0, 1.0, D, device=near_far.device)[None]  # (1, D)
    near, far = near_far[:, :1], near_far[:, 1:]
    if inverse:
        depth_values = 1.0 / (1.0 / near + t * (1.0 / far - 1.0 / near))
    else:
        depth_values = near + t * (far - near)
    return depth_values[:, :, None, None].expand(B, D, H, W).contiguous()


def refined_depth_values(
    depth: torch.Tensor,  # (B, h, w) regressed value of the previous level
    std: torch.Tensor,  # (B, h, w)
    near_far: torch.Tensor,  # (B, 2, h, w) previous-level bounds map
    D: int,
    H: int,
    W: int,
    prev_inverse: bool,
    inverse: bool,
) -> torch.Tensor:
    """(B, D, H, W) hypotheses narrowed to [depth - std, depth + std],
    upsampled to the new volume scale and clamped to the previous bounds."""
    depth = sampling.resize_bilinear_2d(depth, H, W)
    std = sampling.resize_bilinear_2d(std, H, W)
    near_far = sampling.resize_bilinear(near_far.movedim(1, -1), H, W)  # (B,H,W,2)
    if prev_inverse:
        # disparity space: channel 0 = 1/near (large), channel 1 = 1/far
        hi = torch.minimum(depth + std, near_far[..., 0])
        lo = torch.maximum(depth - std, near_far[..., 1])
        band = torch.stack([1.0 / hi, 1.0 / lo], dim=-1)  # metric [near', far']
    else:
        lo = torch.maximum(depth - std, near_far[..., 0])
        hi = torch.minimum(depth + std, near_far[..., 1])
        band = torch.stack([lo, hi], dim=-1)
    t = sampling.linspace(0.0, 1.0, D, device=depth.device)
    if inverse:
        dv = 1.0 / (1.0 / band[..., :1] + t * (1.0 / band[..., 1:] - 1.0 / band[..., :1]))
    else:
        dv = band[..., :1] + t * (band[..., 1:] - band[..., :1])
    return dv.movedim(-1, 1).contiguous()  # (B, D, H, W)


def depth_values_near_far(depth_values: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, 2, H, W) bounds map from the first and last hypotheses; in
    disparity space when ``inverse`` (channel 0 = 1/near). It carries no
    gradient, as in the JAX package (``stop_gradient``)."""
    nf = depth_values[:, [0, -1]]
    if inverse:
        nf = 1.0 / nf.clamp_min(1e-6)
    return nf.detach()


def projected_rows(
    proj_mat: torch.Tensor,  # ([B,] 3, 4) target-pixel+depth -> source-pixel
    depth_values: torch.Tensor,  # ([B,] D, Ht, Wt)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sx, sy, sz) = ``R @ [u, v, 1] + T / depth`` for every plane-sweep
    voxel, each ([B,] D, Ht, Wt), before the perspective division. Written
    elementwise, in the order the CUDA kernels (csrc/warp_variance*.cu)
    round it, so both give the same coordinates."""
    Ht, Wt = depth_values.shape[-2:]
    u = torch.arange(Wt, dtype=torch.float32, device=depth_values.device)
    v = torch.arange(Ht, dtype=torch.float32, device=depth_values.device)[:, None]
    P = proj_mat[..., None, None, None, :, :]  # broadcast over (D, Ht, Wt)

    def row(i):
        base = P[..., i, 0] * u + P[..., i, 1] * v + P[..., i, 2]
        return base + P[..., i, 3] / depth_values

    return row(0), row(1), row(2)


def warp_coords(
    proj_mat: torch.Tensor,  # ([B,] 3, 4)
    depth_values: torch.Tensor,  # ([B,] D, Ht, Wt)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-pixel (x, y) of every plane-sweep voxel, each ([B,] D, Ht, Wt):
    ``projected_rows`` with the perspective division's z clamped at 1e-6."""
    sx, sy, sz = projected_rows(proj_mat, depth_values)
    z = sz.clamp_min(1e-6)
    return sx / z, sy / z


def warp_src_view(
    src_feat: torch.Tensor,  # (Hs, Ws, C) one source view's feature map
    proj_mat: torch.Tensor,  # (3, 4)
    depth_values: torch.Tensor,  # (D, Ht, Wt)
) -> torch.Tensor:
    """Plane-sweep warp of one source view with zeros padding: (D, Ht, Wt, C)."""
    D, Ht, Wt = depth_values.shape
    x, y = warp_coords(proj_mat, depth_values)
    xy = torch.stack([x, y], dim=-1).reshape(-1, 2)
    return sampling.grid_sample_2d(src_feat, xy, "zeros").reshape(D, Ht, Wt, -1)


def variance_volume(
    src_feats: torch.Tensor,  # ([B,] S, Hs, Ws, C)
    proj_mats: torch.Tensor,  # ([B,] S, 3, 4)
    depth_values: torch.Tensor,  # ([B,] D, Ht, Wt)
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Variance cost volume over S warped source views, ([B,] D, Ht, Wt, C):
    the population variance E[x^2] - E[x]^2 over views, out-of-view taps
    contributing zeros. With ``compute_dtype`` bfloat16 the features and
    the tap weights are rounded to bf16 (``sampling.grid_sample_2d``), as
    the Pallas kernel's ``compute_dtype`` rounds its matmul operands; the
    sums and the variance stay float32."""
    if src_feats.dim() == 4:
        return variance_volume(src_feats[None], proj_mats[None], depth_values[None],
                               compute_dtype)[0]
    B, S, Hs, Ws, C = src_feats.shape
    _, D, Ht, Wt = depth_values.shape
    vol_sum = 0.0
    vol_sq = 0.0
    for s in range(S):
        x, y = warp_coords(proj_mats[:, s], depth_values)
        xy = torch.stack([x, y], dim=-1).reshape(B, -1, 2)
        w = sampling.grid_sample_2d(src_feats[:, s], xy, "zeros", compute_dtype)
        vol_sum = vol_sum + w
        vol_sq = vol_sq + w * w
    mean = vol_sum / S
    return (vol_sq / S - mean * mean).reshape(B, D, Ht, Wt, C)
