"""MVSNeRF backbone: one padded cost volume + NDC-space radiance MLP
(counterpart of ``boostmvsnerfs_tpu/models/mvsnerf.py``, eval path, the
``v0`` renderer).

Batch convention (numpy arrays or tensors, JAX layouts):
  all_src_inps  (B, N, H, W, 3)  source images in [-1, 1]
  all_src_exts  (B, N, 4, 4)     world->camera
  all_src_ixts  (B, N, 3, 3)
  tar_ext, tar_ixt               target camera
  depth_ranges  (B, N, 2)        per-view near/far
  ray_idx_0     (B, R)           flat pixel ids at full resolution

The render's three hot loops go through ``ops.cuda``: the trilinear lookup
of the encoding volume (``fused_tri_sample``), the per-view colour lookup
(``fused_row_sample``) and the renderer MLP (``fused_renderer_mlp``, the
positional encoding built in the kernel). Each runs its CUDA kernel on a
CUDA device, the volume lookup and the MLP at bf16 operands as the Pallas
kernels do on the TPU, and its plain PyTorch version in f32 on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.models.blocks import ConvBnLeaky, DeconvBnLeaky
from boostmvsnerfs_torch.models.enerf import to_tensors
from boostmvsnerfs_torch.ops import geometry, render, sampling
from boostmvsnerfs_torch.ops.cuda.img_sample import fused_row_sample
from boostmvsnerfs_torch.ops.cuda.renderer_mlp import (  # noqa: F401 (positional_encoding)
    fused_renderer_mlp,
    positional_encoding,
)
from boostmvsnerfs_torch.ops.cuda.tri_sample import fused_tri_sample


@dataclasses.dataclass(frozen=True)
class MVSNeRFConfig:
    """The settings of the ``v0`` eval math (reference
    configs/exps/pretrain/mvsnerf/dtu_pretrain.yaml). The JAX config's
    TPU-only knobs (``eval_sampling``, ``pallas_*``) and the other renderer
    heads (``net_type``) have no counterpart."""

    pad: int = 24
    mlp_width: int = 128
    mlp_depth: int = 6
    skips: tuple = (4,)
    pos_freqs: int = 10
    num_samples: int = 32  # depth planes AND samples per ray
    n_views: int = 3
    near_far_scale: tuple = (0.8, 1.2)
    k_best: int = 4

    @staticmethod
    def from_cfg(cfg) -> "MVSNeRFConfig":
        """Build from a whole cfg tree, reading what the JAX ``from_cfg``
        reads. ``net_type`` other than ``v0`` (queue 1 item 5) and a
        ``feat_dim`` other than the U-Net's 8 channels raise."""
        mv = cfg.get("mvsnerf", {})
        cas = cfg["enerf"]["cas_config"]
        if mv.get("net_type", "v0") != "v0":
            raise NotImplementedError(
                f"mvsnerf.net_type: {mv['net_type']!r} is not in the port yet "
                "(ROADMAP queue 1 item 5); it takes 'v0'")
        if mv.get("feat_dim", 8) != 8:
            raise NotImplementedError(
                f"mvsnerf.feat_dim: {mv['feat_dim']!r}; the port's volume has 8 channels")
        kw = {k: mv[k] for k in ("pad", "mlp_width", "mlp_depth", "pos_freqs") if k in mv}
        if "near_far_scale" in mv:
            kw["near_far_scale"] = tuple(mv["near_far_scale"])
        kw["num_samples"] = int(cas["num_samples"][0])
        if "k_best" in cas:
            kw["k_best"] = int(cas["k_best"])
        return MVSNeRFConfig(**kw)


class MVSFeatureNet(nn.Module):
    """(N, H, W, 3) -> (N, H/4, W/4, 32). Names ``conv0.{0,1}``,
    ``conv1.{0,1,2}``, ``conv2.{0,1,2}``, ``toplayer`` as in the reference."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnLeaky(3, 8), ConvBnLeaky(8, 8))
        self.conv1 = nn.Sequential(ConvBnLeaky(8, 16, 5, 2), ConvBnLeaky(16, 16),
                                   ConvBnLeaky(16, 16))
        self.conv2 = nn.Sequential(ConvBnLeaky(16, 32, 5, 2), ConvBnLeaky(32, 32),
                                   ConvBnLeaky(32, 32))
        self.toplayer = nn.Conv2d(32, 32, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(self.conv0(x.permute(0, 3, 1, 2))))
        return self.toplayer(x).permute(0, 2, 3, 1).contiguous()


class MVSCostRegNet(nn.Module):
    """3D U-Net, (B, D, H, W, 41) -> (B, D, H, W, 8) neural encoding volume;
    D, H and W must be multiples of 8."""

    def __init__(self, cin: int = 9 + 32):
        super().__init__()
        self.conv0 = ConvBnLeaky(cin, 8, dims=3)
        self.conv1 = ConvBnLeaky(8, 16, stride=2, dims=3)
        self.conv2 = ConvBnLeaky(16, 16, dims=3)
        self.conv3 = ConvBnLeaky(16, 32, stride=2, dims=3)
        self.conv4 = ConvBnLeaky(32, 32, dims=3)
        self.conv5 = ConvBnLeaky(32, 64, stride=2, dims=3)
        self.conv6 = ConvBnLeaky(64, 64, dims=3)
        self.conv7 = DeconvBnLeaky(64, 32)
        self.conv9 = DeconvBnLeaky(32, 16)
        self.conv11 = DeconvBnLeaky(16, 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x.permute(0, 4, 1, 2, 3))
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return x.permute(0, 2, 3, 4, 1).contiguous()


class RendererMLP(nn.Module):
    """``Renderer_ours``: ``pts_bias``-modulated trunk with a skip, relu
    alpha head, sigmoid rgb head on a view-direction branch. Names
    ``pts_linears.{i}``, ``pts_bias``, ``alpha_linear``, ``feature_linear``,
    ``views_linears.0``, ``rgb_linear`` as in the reference."""

    def __init__(self, cfg: MVSNeRFConfig, n_feat: int):
        super().__init__()
        W, enc = cfg.mlp_width, 3 * (1 + 2 * cfg.pos_freqs)
        self.skips = tuple(cfg.skips)
        dims, d = [], enc
        for i in range(cfg.mlp_depth):
            dims.append(d)
            d = W + (enc if i in self.skips else 0)
        self.pts_linears = nn.ModuleList(nn.Linear(i, W) for i in dims)
        self.pts_bias = nn.Linear(n_feat, W)
        self.alpha_linear = nn.Linear(d, 1)
        self.feature_linear = nn.Linear(d, W)
        self.views_linears = nn.ModuleList([nn.Linear(W + 3, W // 2)])
        self.rgb_linear = nn.Linear(W // 2, 3)

    def mlp_params(self) -> dict:
        """{layer: (weight, bias)} under the kernel's layer names."""
        layers = {"pts_bias": self.pts_bias, "alpha": self.alpha_linear,
                  "feature": self.feature_linear, "views_0": self.views_linears[0],
                  "rgb": self.rgb_linear}
        layers.update({f"pts_{i}": m for i, m in enumerate(self.pts_linears)})
        return {k: (m.weight, m.bias) for k, m in layers.items()}

    def forward(self, pts: torch.Tensor, feat: torch.Tensor, dirs: torch.Tensor,
                encode_freqs: int = 0) -> torch.Tensor:
        """pts (B, N, 63) encoded, or raw (B, N, 3) with ``encode_freqs``;
        feat (B, N, F); dirs (B, N, 3) -> raw (rgb, alpha) (B, N, 4)."""
        return fused_renderer_mlp(self.mlp_params(), pts, feat, dirs, encode_freqs)


class _Renderer(nn.Module):
    """Holds the MLP under the reference's ``nerf.nerf`` prefix."""

    def __init__(self, cfg: MVSNeRFConfig, n_feat: int):
        super().__init__()
        self.nerf = RendererMLP(cfg, n_feat)


def mvs_proj_mats(src_ixts: torch.Tensor, src_exts: torch.Tensor,
                  feat_scale: float = 0.25) -> torch.Tensor:
    """Source-view projections relative to the reference (first) view,
    (B, V, 3, 4), identity for view 0."""
    ixts = geometry.scale_ixt(src_ixts, feat_scale)
    proj = torch.zeros(src_exts.shape[:2] + (4, 4), dtype=torch.float32, device=src_exts.device)
    proj[..., 3, 3] = 1.0
    proj[..., :3, :] = ixts @ src_exts[..., :3, :]
    rel = proj @ torch.linalg.inv(proj[:, :1])
    eye = torch.eye(4, device=rel.device).expand_as(rel[:, :1])
    return torch.cat([eye, rel[:, 1:]], dim=1)[..., :3, :]


def ndc_coords(w2c_ref, ixt_ref, pts, inv_scale, near, far, pad: int, feat_hw) -> torch.Tensor:
    """Pad-aware NDC coordinates of points (B, P, 3) in the reference view,
    (B, P, 3): pixel x, y over [W-1, H-1] and depth over [near, far], then
    shrunk into the padded feature frame."""
    R = w2c_ref[..., :3, :3]
    T = w2c_ref[..., :3, 3]
    cam = pts @ R.transpose(-1, -2) + T[..., None, :]
    pix = cam @ ixt_ref.transpose(-1, -2)
    xy = pix[..., :2] / pix[..., 2:3] / inv_scale
    z = (pix[..., 2:3] - near) / (far - near)
    uvd = torch.cat([xy, z], dim=-1)
    if pad > 0:
        Hf, Wf = feat_hw
        dev = uvd.device
        scale = torch.tensor([Wf / (Wf + 2 * pad), Hf / (Hf + 2 * pad), 1.0], device=dev)
        off = torch.tensor([pad / (Wf + 2 * pad), pad / (Hf + 2 * pad), 0.0], device=dev)
        uvd = uvd * scale + off
    return uvd


def depth_line(near: torch.Tensor, far: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` depths uniform in [near, far] per batch entry, (B, n)."""
    t = sampling.linspace(0.0, 1.0, n, device=near.device)
    return near[:, None] * (1.0 - t) + far[:, None] * t


class MVSNeRF(nn.Module):
    """Single-cost-volume MVSNeRF network. Parameter names follow the
    reference (``feature.*``, ``cost_reg_2.*``, ``nerf.nerf.*``). Runs on
    CUDA unless ``device`` says otherwise; BatchNorm is in eval mode."""

    def __init__(self, cfg: MVSNeRFConfig = MVSNeRFConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.feature = MVSFeatureNet()
        self.cost_reg_2 = MVSCostRegNet()
        self.nerf = _Renderer(cfg, 8 + 4 * cfg.n_views)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def extract_features(self, all_src_inps: torch.Tensor) -> torch.Tensor:
        B, V = all_src_inps.shape[:2]
        f = self.feature(all_src_inps.reshape(B * V, *all_src_inps.shape[2:]))
        return f.reshape(B, V, *f.shape[1:])  # (B, V, H/4, W/4, 32)

    def raw_volume(self, src_inps, feats, proj_mats, depth_values) -> torch.Tensor:
        """Padded cost volume, (B, D, h+2p, w+2p, 9+32): the reference
        view's RGB, each source view's RGB warped by the plane sweep (both in
        the inputs' [-1, 1]), and the variance of the features over the views
        that see each voxel. src_inps (B, V, H, W, 3), feats (B, V, h, w, 32),
        depth_values (B, D)."""
        B, V, h, w, C = feats.shape
        H, W = src_inps.shape[2:4]
        D = depth_values.shape[1]
        p = self.cfg.pad
        hp, wp = h + 2 * p, w + 2 * p
        imgs = sampling.resize_antialiased(src_inps.reshape(B * V, H, W, 3), h, w)
        imgs = imgs.reshape(B, V, h, w, 3)

        dev = feats.device
        ys, xs = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev) - p,
                                torch.arange(wp, dtype=torch.float32, device=dev) - p,
                                indexing="ij")
        g = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (hp, wp, 3)

        def padded(x):  # (B, h, w, c) -> (B, D, hp, wp, c)
            return F.pad(x, (0, 0, p, p, p, p))[:, None].expand(B, D, hp, wp, x.shape[-1])

        vol_sum = padded(feats[:, 0])
        vol_sq = vol_sum**2
        counts = torch.ones((B, D, hp, wp, 1), device=dev)
        rgb_chans = [padded(imgs[:, 0])]
        for v in range(1, V):
            pm = proj_mats[:, v]  # (B, 3, 4)
            base = torch.einsum("hwc,brc->bhwr", g, pm[:, :, :3])
            src = base[:, None] + pm[:, None, None, None, :, 3] / depth_values[:, :, None, None, None]
            xy = (src[..., :2] / src[..., 2:3]).reshape(B, -1, 2)
            wf = sampling.grid_sample_2d(feats[:, v], xy, "zeros").reshape(B, D, hp, wp, C)
            wrgb = sampling.grid_sample_2d(imgs[:, v], xy, "zeros").reshape(B, D, hp, wp, 3)
            x, y = xy[..., 0], xy[..., 1]
            valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
            vol_sum = vol_sum + wf
            vol_sq = vol_sq + wf * wf
            counts = counts + valid.float().reshape(B, D, hp, wp, 1)
            rgb_chans.append(wrgb)
        inv_c = 1.0 / counts
        var = vol_sq * inv_c - (vol_sum * inv_c) ** 2
        return torch.cat(rgb_chans + [var], dim=-1)

    def build_volume(self, src_inps, feats, proj_mats, depth_values) -> torch.Tensor:
        """The regularised 8-ch encoding volume, (B, D, h+2p, w+2p, 8)."""
        return self.cost_reg_2(self.raw_volume(src_inps, feats, proj_mats, depth_values))

    def sample_points(self, batch, ray_idx, near, far):
        """Uniform depth samples of the rays at ``ray_idx`` (B, R):
        (world_xyz (B, R, D, 3), ray_d (B, R, 3), z_vals (B, R, D))."""
        W = batch["src_inps"].shape[3]
        xy = geometry.flat_idx_to_xy(ray_idx, W)
        ray_o, ray_d = geometry.rays_from_pixels(batch["tar_ixt"], batch["tar_ext"], xy)
        B, R = ray_idx.shape
        z_vals = depth_line(near, far, self.cfg.num_samples)[:, None, :].expand(B, R, -1)
        world_xyz = ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]
        return world_xyz, ray_d, z_vals

    def volume_coords(self, batch, volume, pts, near, far):
        """Points (B, P, 3) in the reference view's padded NDC frame, uvd
        (B, P, 3) in [0, 1] inside the volume, and as voxel coordinates
        (x, y, z) of the encoding volume in align-corners units (B, P, 3)."""
        B, _, H, W = batch["src_inps"].shape[:4]
        inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=pts.device)
        uvd = ndc_coords(batch["src_exts"][:, 0], batch["src_ixts"][:, 0], pts, inv_scale,
                         near.reshape(B, 1, 1), far.reshape(B, 1, 1), self.cfg.pad,
                         (H // 4, W // 4))
        Dp, hp, wp = volume.shape[1:4]
        return uvd, uvd * torch.tensor([wp - 1, hp - 1, Dp - 1], dtype=torch.float32,
                                       device=pts.device)

    def view_colors(self, batch, pts):
        """Each source view's projection of points (B, P, 3): pixel x and y,
        (B*V, P) each, and the in-frame masks (B, V, P)."""
        B, V, H, W = batch["src_inps"].shape[:4]
        xs, ys, masks = [], [], []
        for v in range(V):
            xy, _ = geometry.project_points(pts, batch["src_exts"][:, v], batch["src_ixts"][:, v])
            x, y = xy[..., 0], xy[..., 1]
            masks.append(((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).float())
            xs.append(x)
            ys.append(y)
        return torch.stack(xs, 1).reshape(B * V, -1), torch.stack(ys, 1).reshape(B * V, -1), \
            torch.stack(masks, 1)

    def render_stages(self, batch, volume, ray_idx, near, far):
        """The render up to its MLP: samples, the volume lookup (kernel
        ``tri_sample``) and the colour lookup (``img_sample``). Returns each
        kernel's arguments as this render passes them, {'tri_sample',
        'img_sample', 'renderer_mlp'}, the samples (B, R, D, 3) and their z
        values (B, R, D)."""
        B, V, H, W = batch["src_inps"].shape[:4]
        world_xyz, ray_d, z_vals = self.sample_points(batch, ray_idx, near, far)
        R, D = z_vals.shape[1:]
        pts = world_xyz.reshape(B, -1, 3)
        uvd, vox_xyz = self.volume_coords(batch, volume, pts, near, far)
        x, y, masks = self.view_colors(batch, pts)
        rgbs = render.unpreprocess(batch["src_inps"]).reshape(B * V, H, W, 3)
        calls = {"tri_sample": (volume, vox_xyz, D), "img_sample": (rgbs, x, y, "border")}
        vox = fused_tri_sample(*calls["tri_sample"])  # (B, R*D, 8), bf16 on the card
        col = fused_row_sample(*calls["img_sample"]).reshape(B, V, -1, 3)
        feat = torch.cat([vox, torch.cat([col, masks[..., None]], -1).movedim(1, 2)
                          .reshape(B, R * D, 4 * V)], dim=-1)  # [vox 8, (rgb, mask) per view]
        dirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        dirs = dirs @ batch["src_exts"][:, 0, :3, :3].transpose(-1, -2)  # reference frame
        dirs = dirs[:, :, None, :].expand(B, R, D, 3).reshape(B, R * D, 3)
        calls["renderer_mlp"] = (self.nerf.nerf.mlp_params(), uvd.contiguous(), feat, dirs,
                                 self.cfg.pos_freqs)
        return calls, world_xyz, z_vals

    def render_volume(self, batch, volume, ray_idx, near, far, with_mask: bool = True) -> dict:
        """Raw per-sample outputs {'net_output' (B, R, D, 4), 'z_vals'
        (B, R, D)[, 'mask' (B, R, D)]}."""
        calls, world_xyz, z_vals = self.render_stages(batch, volume, ray_idx, near, far)
        out = {"net_output": fused_renderer_mlp(*calls["renderer_mlp"]).reshape(*z_vals.shape, 4),
               "z_vals": z_vals}
        if with_mask:
            B, _, H, W = batch["src_inps"].shape[:4]
            inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=z_vals.device)
            out["mask"] = render.mask_viewport(world_xyz, batch["src_exts"], batch["src_ixts"],
                                               inv_scale.expand(B, 2))
        return out

    def near_far(self, depth_ranges: torch.Tensor):
        """Scene bounds of each batch entry from its views' depth ranges
        (B, V, 2), widened by ``near_far_scale``: (near (B,), far (B,))."""
        s = self.cfg.near_far_scale
        return depth_ranges[..., 0].amin(1) * s[0], depth_ranges[..., 1].amax(1) * s[1]

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        batch = to_tensors(batch, self.device)
        V = self.cfg.n_views
        feats = self.extract_features(batch["all_src_inps"])
        sub = {k: batch[f"all_{k}"][:, :V] for k in ("src_inps", "src_exts", "src_ixts")}
        sub.update(tar_ext=batch["tar_ext"], tar_ixt=batch["tar_ixt"])
        near, far = self.near_far(batch["depth_ranges"][:, :V])
        pm = mvs_proj_mats(sub["src_ixts"], sub["src_exts"])
        volume = self.build_volume(sub["src_inps"], feats[:, :V], pm,
                                   depth_line(near, far, self.cfg.num_samples))
        raw = self.render_volume(sub, volume, batch["ray_idx_0"], near, far, with_mask=False)
        # composited with ENeRF's raw2outputs (softmax-normalised depth), as
        # the reference's mvsnerf forward does
        out = render.composite(raw["net_output"], raw["z_vals"], softmax_depth=True)
        return {f"{k}_level0": v for k, v in out.items()}
