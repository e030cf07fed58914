"""Volume rendering: depth regression, depth-guided sampling, compositing.

Counterpart of ``boostmvsnerfs_tpu/ops/render.py``, including the paper's
multi cost-volume blend (``composite_blend``).
"""

from __future__ import annotations

import torch

from . import geometry, sampling


def depth_regression(
    logits: torch.Tensor,  # (B, D, H, W) depth probability logits
    depth_values: torch.Tensor,  # (B, D, H, W) metric depth hypotheses
    inverse: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax-expectation depth and standard deviation, each (B, H, W);
    disparities when ``inverse``."""
    prob = torch.softmax(logits, dim=1)
    if inverse:
        depth_values = 1.0 / depth_values.clamp_min(1e-6)
    depth = torch.sum(prob * depth_values, dim=1)
    var = torch.sum(prob * (depth_values - depth[:, None]) ** 2, dim=1)
    return depth, torch.sqrt(var.clamp_min(1e-10))


def ray_bounds_maps(
    depth: torch.Tensor,  # (B, h, w) regressed depth (disparity if inverse)
    std: torch.Tensor,  # (B, h, w)
    near_far: torch.Tensor,  # (B, 2, h, w) volume bounds map
    H: int,
    W: int,
    inverse: bool,
) -> torch.Tensor:
    """Per-pixel [ray_near, ray_far, vol_near, vol_far], (B, H, W, 4): the
    band [depth - std, depth + std] clamped to the volume bounds, upsampled
    to render resolution."""
    depth = sampling.resize_bilinear_2d(depth, H, W)
    std = sampling.resize_bilinear_2d(std, H, W)
    nf = sampling.resize_bilinear(near_far.movedim(1, -1), H, W)  # (B, H, W, 2)
    if inverse:
        ray_near = torch.minimum(depth + std, nf[..., 0])
        ray_far = torch.maximum(depth - std, nf[..., 1])
    else:
        ray_near = torch.maximum(depth - std, nf[..., 0])
        ray_far = torch.minimum(depth + std, nf[..., 1])
    return torch.stack([ray_near, ray_far, nf[..., 0], nf[..., 1]], dim=-1)


def sample_along_depth(
    ray_o: torch.Tensor,  # (B, N, 3)
    ray_d: torch.Tensor,  # (B, N, 3) unnormalised (z-depth parameterisation)
    bounds: torch.Tensor,  # (B, N, 4) [ray_near, ray_far, vol_near, vol_far]
    uv: torch.Tensor,  # (B, N, 2) pixel coords at render scale
    N_samples: int,
    inverse: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World samples (B, N, S, 3), volume coords uvd (B, N, S, 3) with d
    normalised against the per-pixel volume bounds, and z values (B, N, S)
    uniform in the [ray_near, ray_far] band."""
    near, far = bounds[..., 0:1], bounds[..., 1:2]
    vnear, vfar = bounds[..., 2:3], bounds[..., 3:4]
    if N_samples == 1:
        z_vals = near + (far - near) * 0.5
    else:
        t = sampling.linspace(0.0, 1.0, N_samples, device=bounds.device)
        z_vals = near + (far - near) * t
    if inverse:
        depth = 1.0 / z_vals.clamp_min(1e-6)
        d = (vnear - z_vals) / (vnear - vfar).clamp_min(1e-6)
    else:
        depth = z_vals
        d = (z_vals - vnear) / (vfar - vnear).clamp_min(1e-6)
    world_xyz = ray_o[..., None, :] + ray_d[..., None, :] * depth[..., None]
    S = z_vals.shape[-1]
    uvd = torch.cat([uv[..., None, :].expand(*uv.shape[:2], S, 2), d[..., None]], dim=-1)
    return world_xyz, uvd, z_vals


def composite(
    raw: torch.Tensor,  # (B, N, S, 4) rgb + density
    z_vals: torch.Tensor | None,  # (B, N, S)
    softmax_depth: bool = True,
) -> dict:
    """Alpha compositing with an exclusive transmittance cumprod; the depth
    map softmax-normalises the weights (ENeRF) unless ``softmax_depth`` is
    False (MVSNeRF). The depth map's z values carry no gradient, as in the
    JAX package."""
    alpha = 1.0 - torch.exp(-raw[..., 3])
    T = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    T = torch.cat([torch.ones_like(T[..., :1]), T[..., :-1]], dim=-1)
    weights = alpha * T
    out = {"rgb": torch.sum(weights[..., None] * raw[..., :3], dim=-2), "weights": weights}
    if z_vals is not None:
        w = torch.softmax(weights, dim=-1) if softmax_depth else weights
        out["depth"] = torch.sum(w * z_vals.detach(), dim=-1)
    return out


def composite_blend(
    raws: torch.Tensor,  # (B, K, N, S, 4) per-cost-volume raw outputs
    masks: torch.Tensor,  # (B, K, N, S) normalised visibility weights
    z_vals: torch.Tensor | None,  # (B, K, N, S)
) -> dict:
    """Multi cost-volume fused rendering, the paper's contribution: the K
    volumes' per-sample alphas blend with visibility weights into ONE
    transmittance integral, and radiance accumulates per volume against the
    shared transmittance. As in ``composite``, the depth map's z values
    carry no gradient."""
    alpha_all = 1.0 - torch.exp(-raws[..., 3])  # (B, K, N, S)
    alphas = torch.sum(alpha_all * masks, dim=1)  # (B, N, S)
    T = torch.cumprod(
        torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas], dim=-1), dim=-1
    )[..., :-1]
    weights = alphas * T
    rgb = torch.sum(
        (T[:, None] * alpha_all * masks)[..., None] * raws[..., :3], dim=(-2, 1)
    )  # (B, N, 3)
    out = {"rgb": rgb, "weights": weights}
    if z_vals is not None:
        w = torch.softmax(weights, dim=-1)
        out["depth"] = torch.sum(w * torch.mean(z_vals, dim=1).detach(), dim=-1)
    return out


def normalize_blend_masks(masks: torch.Tensor) -> torch.Tensor:
    """Normalise per-volume visibility masks across K (dim 1), with a
    uniform 1/K where no volume sees the sample."""
    K = masks.shape[1]
    total = torch.sum(masks, dim=1, keepdim=True)
    return torch.where(total > 0, masks / total, 1.0 / K)


def viewport_visibility(
    world_xyz: torch.Tensor,  # (B, N, S, 3)
    src_exts: torch.Tensor,  # (B, V, 4, 4)
    src_ixts: torch.Tensor,  # (B, V, 3, 3)
    inv_scale: torch.Tensor,  # (B, 2) = [W-1, H-1] at render scale
) -> torch.Tensor:
    """Whether each source view sees each sample, (B, V, N*S) as float
    0/1: its normalised projection lies in [0, 1]^2 with positive depth."""
    B, N, S = world_xyz.shape[:3]
    pts = world_xyz.reshape(B, N * S, 3)
    vis = []
    for v in range(src_exts.shape[1]):
        xy, depth = geometry.project_points(pts, src_exts[:, v], src_ixts[:, v])
        uv = xy / inv_scale[:, None, :]
        vis.append((
            (uv[..., 0] >= 0) & (uv[..., 0] <= 1)
            & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
            & (depth[..., 0] > 0)
        ).float())
    return torch.stack(vis, 1)


def mask_viewport(
    world_xyz: torch.Tensor,  # (B, N, S, 3)
    src_exts: torch.Tensor,  # (B, V, 4, 4)
    src_ixts: torch.Tensor,  # (B, V, 3, 3)
    inv_scale: torch.Tensor,  # (B, 2) = [W-1, H-1] at render scale
) -> torch.Tensor:
    """Fraction of source views seeing each sample (``viewport_visibility``),
    (B, N, S)."""
    V = src_exts.shape[1]
    B, N, S = world_xyz.shape[:3]
    vis = viewport_visibility(world_xyz, src_exts, src_ixts, inv_scale)
    return (vis.sum(1) / V).reshape(B, N, S)


def unpreprocess(src_inps: torch.Tensor, render_scale: float = 1.0) -> torch.Tensor:
    """Map network inputs in [-1, 1] back to RGB in [0, 1], optionally
    resized by ``render_scale``."""
    img = src_inps * 0.5 + 0.5
    if render_scale != 1.0:
        H, W = img.shape[-3], img.shape[-2]
        img = sampling.resize_bilinear(img, int(H * render_scale), int(W * render_scale))
    return img
