"""Camera geometry: projective matrices and ray generation.

Counterpart of ``boostmvsnerfs_tpu/ops/geometry.py``. Conventions:
extrinsics ``ext`` are world->camera (w2c) 4x4, intrinsics 3x3, image
coordinates (x, y) in pixel units with align-corners semantics (pixel
centers at integers, valid range [0, W-1] x [0, H-1]).
"""

from __future__ import annotations

import torch


def scale_ixt(ixt: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale the first two rows of (..., 3, 3) intrinsics by ``scale``."""
    out = ixt.clone()
    out[..., :2, :] *= scale
    return out


def proj_mats(
    src_ixts: torch.Tensor,  # (B, S, 3, 3)
    src_exts: torch.Tensor,  # (B, S, 4, 4) w2c
    tar_ixt: torch.Tensor,  # (B, 3, 3)
    tar_ext: torch.Tensor,  # (B, 4, 4) w2c
    src_scale: float,
    tar_scale: float,
) -> torch.Tensor:
    """Target-pixel+depth -> source-pixel projective matrices, (B, S, 3, 4):
    ``K_s [R_s|t_s]`` right-multiplied by the inverse of the target
    projection promoted to 4x4 with a [0, 0, 0, 1] row."""
    src_projs = scale_ixt(src_ixts, src_scale) @ src_exts[..., :3, :]
    tar_proj = scale_ixt(tar_ixt, tar_scale) @ tar_ext[..., :3, :]  # (B,3,4)
    bottom = torch.zeros_like(tar_proj[..., :1, :])
    bottom[..., 0, 3] = 1.0
    tar_proj_inv = torch.linalg.inv(torch.cat([tar_proj, bottom], dim=-2))
    return src_projs @ tar_proj_inv[:, None]


def rays_from_pixels(
    tar_ixt: torch.Tensor,  # (B, 3, 3), at render scale
    tar_ext: torch.Tensor,  # (B, 4, 4) w2c
    xy: torch.Tensor,  # (B, N, 2) pixel coordinates (x, y)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray origins (B, N, 3) and unnormalised directions (B, N, 3):
    ``[x, y, 1] @ inv(K)^T @ R_c2w^T`` (z-depth parameterisation)."""
    c2w = torch.linalg.inv(tar_ext)
    ray_o = c2w[:, :3, 3]
    xy1 = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    mat = torch.linalg.inv(tar_ixt).transpose(-1, -2) @ c2w[:, :3, :3].transpose(-1, -2)
    ray_d = xy1 @ mat
    return ray_o[:, None].expand(-1, xy.shape[1], -1), ray_d


def flat_idx_to_xy(idx: torch.Tensor, W: int) -> torch.Tensor:
    """Flat row-major pixel index -> (x, y) float coordinates, (..., 2)."""
    return torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)


def project_points(
    world_xyz: torch.Tensor,  # (B, ..., 3)
    ext: torch.Tensor,  # (B, 4, 4) w2c
    ixt: torch.Tensor,  # (B, 3, 3)
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points into a camera: ((..., 2) pixels, (..., 1) depth).
    The pixel division clamps depth at ``eps``."""
    R = ext[..., :3, :3]
    t = ext[..., :3, 3]
    cam = world_xyz @ R.transpose(-1, -2) + t[..., None, :]
    pix = cam @ ixt.transpose(-1, -2)
    depth = pix[..., 2:3]
    return pix[..., :2] / depth.clamp_min(eps), depth


def cam_center(ext: torch.Tensor) -> torch.Tensor:
    """Camera center in world coordinates from a w2c extrinsic: -R^T t."""
    return (-ext[..., :3, :3].transpose(-1, -2) @ ext[..., :3, 3:])[..., 0]
