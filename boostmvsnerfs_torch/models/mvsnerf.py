"""MVSNeRF backbone: one padded cost volume + NDC-space radiance MLP
(counterpart of ``boostmvsnerfs_tpu/models/mvsnerf.py``, eval and training,
every renderer head of ``net_type``).

Batch convention (numpy arrays or tensors, JAX layouts):
  all_src_inps  (B, N, H, W, 3)  source images in [-1, 1]
  all_src_exts  (B, N, 4, 4)     world->camera
  all_src_ixts  (B, N, 3, 3)
  tar_ext, tar_ixt               target camera
  depth_ranges  (B, N, 2)        per-view near/far
  ray_idx_0     (B, R)           flat pixel ids at full resolution

The render's three hot loops go through ``ops.cuda``: the trilinear lookup
of the encoding volume (``fused_tri_sample``), the per-view colour lookup
(``fused_row_sample``) and, for the ``v0`` head, the renderer MLP
(``fused_renderer_mlp``, the positional encoding built in the kernel).
Each runs its CUDA kernel on a CUDA device, the volume lookup and the MLP
at bf16 operands as the Pallas kernels do on the TPU, and its plain
PyTorch version in f32 on the CPU. The other heads (``v2``, ``v1`` /
``attention``, ``color_fusion``) run their MLPs plainly on every device,
as JAX runs them under XLA: the kernel has only the ``v0`` trunk.

The module's own mode takes the place of the JAX module's ``train``
argument (``MVSNeRF.volume_lookup`` / ``radiance``): after ``model.train()``
the volume lookup and the MLP take their plain versions in f32 under
autograd (neither kernel has a backward, in JAX either), the colour lookup
keeps kernel #3 (it needs no gradient: its inputs are the source images
and the cameras) and BatchNorm uses batch statistics; after
``model.eval()`` the kernels and the running statistics.
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
from boostmvsnerfs_torch.ops.cuda.renderer_mlp import (
    fused_renderer_mlp,
    mlp_trunk,
    positional_encoding,
    renderer_mlp_plain,
)
from boostmvsnerfs_torch.ops.cuda.tri_sample import fused_tri_sample, tri_sample_plain

# renderer heads (reference network.py:548-567 ``net_type``): 'v0'
# Renderer_ours, 'v2' Renderer_linear, 'v1' / 'attention'
# Renderer_attention, 'color_fusion' Renderer_color_fusion
NET_TYPES = ("v0", "v2", "v1", "attention", "color_fusion")
# the heads whose MLP is the renderer-MLP kernel's (#8) multiplying trunk
KERNEL_HEADS = ("v0",)


@dataclasses.dataclass(frozen=True)
class MVSNeRFConfig:
    """The settings of the MVSNeRF math (reference
    configs/exps/pretrain/mvsnerf/dtu_pretrain.yaml). The JAX config's
    TPU-only knobs (``eval_sampling``, ``pallas_*``) have no counterpart."""

    pad: int = 24
    mlp_width: int = 128
    mlp_depth: int = 6
    skips: tuple = (4,)
    pos_freqs: int = 10
    num_samples: int = 32  # depth planes AND samples per ray
    n_views: int = 3
    net_type: str = "v0"
    near_far_scale: tuple = (0.8, 1.2)
    k_best: int = 4
    cost_volume_input_views: int = 3

    def __post_init__(self):
        if self.net_type not in NET_TYPES:
            raise ValueError(f"mvsnerf.net_type {self.net_type!r}; one of {NET_TYPES}")

    @staticmethod
    def from_cfg(cfg) -> "MVSNeRFConfig":
        """Build from a whole cfg tree, reading what the JAX ``from_cfg``
        reads. A ``feat_dim`` other than the U-Net's 8 channels raises."""
        mv = cfg.get("mvsnerf", {})
        cas = cfg["enerf"]["cas_config"]
        if mv.get("feat_dim", 8) != 8:
            raise NotImplementedError(
                f"mvsnerf.feat_dim: {mv['feat_dim']!r}; the port's volume has 8 channels")
        kw = {k: mv[k] for k in ("pad", "mlp_width", "mlp_depth", "pos_freqs", "net_type")
              if k in mv}
        if "near_far_scale" in mv:
            kw["near_far_scale"] = tuple(mv["near_far_scale"])
        kw["num_samples"] = int(cas["num_samples"][0])
        if "k_best" in cas:
            kw["k_best"] = int(cas["k_best"])
        if "cost_volume_input_views" in cfg["enerf"]:
            kw["cost_volume_input_views"] = int(cfg["enerf"]["cost_volume_input_views"])
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


def _trunk_dims(cfg: MVSNeRFConfig, skips) -> tuple[list, int]:
    """Input widths of the trunk's ``pts_{i}`` layers and the width of its
    last hidden state: a layer after a skip takes the encoding in front."""
    W, enc = cfg.mlp_width, 3 * (1 + 2 * cfg.pos_freqs)
    dims, d = [], enc
    for i in range(cfg.mlp_depth):
        dims.append(d)
        d = W + (enc if i in skips else 0)
    return dims, d


class RendererMLP(nn.Module):
    """``Renderer_ours`` (``v0``): ``pts_bias``-modulated trunk with a skip,
    relu alpha head, sigmoid rgb head on a view-direction branch. With
    ``additive_bias`` it is ``Renderer_linear`` (``v2``): the same layers,
    each trunk layer adding the bias instead of multiplying by it. Names
    ``pts_linears.{i}``, ``pts_bias``, ``alpha_linear``, ``feature_linear``,
    ``views_linears.0``, ``rgb_linear`` as in the reference."""

    def __init__(self, cfg: MVSNeRFConfig, n_feat: int, additive_bias: bool = False):
        super().__init__()
        W = cfg.mlp_width
        dims, d = _trunk_dims(cfg, cfg.skips)
        self.additive_bias = additive_bias
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
        """The plain version, differentiable: pts (B, N, 63) encoded, or raw
        (B, N, 3) with ``encode_freqs``; feat (B, N, F); dirs (B, N, 3) ->
        raw (rgb, alpha) (B, N, 4)."""
        return renderer_mlp_plain(self.mlp_params(), pts, feat, dirs, encode_freqs,
                                  additive_bias=self.additive_bias)


class MultiHeadAttention(nn.Module):
    """Attention over a sample's view tokens (reference network.py:77-148):
    bias-free ``w_qs`` / ``w_ks`` / ``w_vs``, scaled dot-product softmax
    (scores where ``mask`` is 0 set to -1e9), ``fc``, residual and
    ``layer_norm`` (eps 1e-6). Plain ``nn.Linear`` work: 3 tokens a sample."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v, mask=None):
        """q, k, v (B, L, d_model); mask (B, L, 1) or None -> (out (B, L,
        d_model), attention (B, n_head, L, L))."""
        nh, dk, dv = self.n_head, self.d_k, self.d_v
        B, L = q.shape[:2]
        qp = self.w_qs(q).reshape(B, L, nh, dk).transpose(1, 2)
        kp = self.w_ks(k).reshape(B, k.shape[1], nh, dk).transpose(1, 2)
        vp = self.w_vs(v).reshape(B, v.shape[1], nh, dv).transpose(1, 2)
        attn = (qp / dk ** 0.5) @ kp.transpose(-1, -2)
        if mask is not None:
            attn = attn.masked_fill(mask[:, None] == 0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ vp).transpose(1, 2).reshape(B, L, nh * dv)
        return self.layer_norm(self.fc(out) + q), attn


def _view_tokens(feat: torch.Tensor):
    """feat (B, N, 8 + 4V) -> (volume features (B, N, 8), each view's
    (rgb, in-mask) (B*N, V, 4))."""
    B, N, F_ = feat.shape
    V = (F_ - 8) // 4
    return feat[..., :8], feat[..., 8:].reshape(B * N, V, 4)


class RendererAttention(nn.Module):
    """``Renderer_attention`` (``v1`` / ``attention``, reference
    network.py:391-469): each view's (rgb, mask) token with the sample's 8
    volume channels goes through ``color_attention``; ``weight_out``'s
    per-view sigmoid colours, summed, join the volume channels as the
    ``pts_bias`` input (11 channels), and the trunk adds that bias with no
    skip. The reference ties ``pts_linears.1..D-1`` to one module; this
    head keeps one per layer, as JAX does. Only (rgb, alpha) come back:
    the reference also appends its fused colours, which its compositing
    never reads."""

    def __init__(self, cfg: MVSNeRFConfig, n_feat: int):
        super().__init__()
        W = cfg.mlp_width
        dims, d = _trunk_dims(cfg, ())
        self.color_attention = MultiHeadAttention(4, 12, 4, 4)
        self.weight_out = nn.Linear(12, 3)
        self.pts_linears = nn.ModuleList(nn.Linear(i, W) for i in dims)
        self.pts_bias = nn.Linear(8 + 3, W)
        self.alpha_linear = nn.Linear(d, 1)
        self.feature_linear = nn.Linear(d, W)
        self.views_linears = nn.ModuleList([nn.Linear(W + 3, W // 2)])
        self.rgb_linear = nn.Linear(W // 2, 3)

    mlp_params = RendererMLP.mlp_params

    def forward(self, pts, feat, dirs, encode_freqs: int = 0) -> torch.Tensor:
        """As ``RendererMLP.forward``."""
        B, N = feat.shape[:2]
        vox, colors4 = _view_tokens(feat)
        V = colors4.shape[1]
        tok = torch.cat([colors4, vox.reshape(B * N, 1, 8).expand(B * N, V, 8)], dim=-1)
        tok, _ = self.color_attention(tok, tok, tok)
        colors = torch.sigmoid(self.weight_out(tok)).sum(-2).reshape(B, N, 3)
        return renderer_mlp_plain(self.mlp_params(), pts, torch.cat([vox, colors], dim=-1),
                                  dirs, encode_freqs, additive_bias=True)


class RendererColorFusion(nn.Module):
    """``Renderer_color_fusion`` (reference network.py:231-311): the ``v0``
    trunk, a relu alpha head and a 16-wide relu ``feature_linear``; each
    view's token (the feature, one view-direction component, the view's
    rgb) goes through the masked ``ray_attention``, and ``rgb_out``'s
    per-view sigmoid colours are summed. Names ``alpha_linear.0``,
    ``feature_linear.0``, ``rgb_out.0`` as in the reference."""

    def __init__(self, cfg: MVSNeRFConfig, n_feat: int):
        super().__init__()
        W = cfg.mlp_width
        dims, d = _trunk_dims(cfg, cfg.skips)
        V = (n_feat - 8) // 4
        d_tok = 16 + 3 // V + 3
        self.pts_linears = nn.ModuleList(nn.Linear(i, W) for i in dims)
        self.pts_bias = nn.Linear(n_feat, W)
        self.alpha_linear = nn.Sequential(nn.Linear(d, 1))
        self.feature_linear = nn.Sequential(nn.Linear(d, 16))
        self.ray_attention = MultiHeadAttention(4, d_tok, 4, 4)
        self.rgb_out = nn.Sequential(nn.Linear(d_tok, 3))

    def forward(self, pts, feat, dirs, encode_freqs: int = 0) -> torch.Tensor:
        """As ``RendererMLP.forward``."""
        if encode_freqs:
            pts = positional_encoding(pts, encode_freqs)
        B, N = feat.shape[:2]
        layers = {"pts_bias": self.pts_bias, "alpha": self.alpha_linear[0]}
        layers.update({f"pts_{i}": m for i, m in enumerate(self.pts_linears)})
        h = mlp_trunk({k: (m.weight, m.bias) for k, m in layers.items()}, pts, feat)
        alpha = F.relu(self.alpha_linear(h))
        feature = F.relu(self.feature_linear(h))
        _, colors4 = _view_tokens(feat)
        V = colors4.shape[1]
        tok = torch.cat([feature.reshape(B * N, 1, 16).expand(B * N, V, 16),
                         dirs.reshape(B * N, V, -1), colors4[..., :3]], dim=-1)
        tok, _ = self.ray_attention(tok, tok, tok, mask=colors4[..., 3:])
        rgb = torch.sigmoid(self.rgb_out(tok)).sum(-2).reshape(B, N, 3)
        return torch.cat([rgb, alpha], dim=-1)


HEADS = {
    "v0": RendererMLP,
    "v2": lambda cfg, n_feat: RendererMLP(cfg, n_feat, additive_bias=True),
    "v1": RendererAttention,
    "attention": RendererAttention,
    "color_fusion": RendererColorFusion,
}


class _Renderer(nn.Module):
    """Holds the ``net_type`` head under the reference's ``nerf.nerf``
    prefix."""

    def __init__(self, cfg: MVSNeRFConfig, n_feat: int):
        super().__init__()
        self.nerf = HEADS[cfg.net_type](cfg, n_feat)


def mvs_proj_mats(src_ixts: torch.Tensor, src_exts: torch.Tensor,
                  feat_scale: float = 0.25) -> torch.Tensor:
    """Source-view projections relative to the reference (first) view,
    (B, V, 3, 4), identity for view 0."""
    ixts = geometry.scale_ixt(src_ixts, feat_scale)
    proj = src_exts.new_zeros(src_exts.shape[:2] + (4, 4))
    proj[..., 3, 3] = 1.0
    proj[..., :3, :] = ixts @ src_exts[..., :3, :]
    rel = proj @ torch.linalg.inv(proj[:, :1])
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device).expand_as(rel[:, :1])
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
    t = sampling.linspace(0.0, 1.0, n, device=near.device, dtype=near.dtype)
    return near[:, None] * (1.0 - t) + far[:, None] * t


class MVSNeRF(nn.Module):
    """Single-cost-volume MVSNeRF network. Parameter names follow the
    reference (``feature.*``, ``cost_reg_2.*``, ``nerf.nerf.*``). Runs on
    CUDA unless ``device`` says otherwise. Built in eval mode."""

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
        ys, xs = torch.meshgrid(torch.arange(hp, dtype=feats.dtype, device=dev) - p,
                                torch.arange(wp, dtype=feats.dtype, device=dev) - p,
                                indexing="ij")
        g = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (hp, wp, 3)

        def padded(x):  # (B, h, w, c) -> (B, D, hp, wp, c)
            return F.pad(x, (0, 0, p, p, p, p))[:, None].expand(B, D, hp, wp, x.shape[-1])

        vol_sum = padded(feats[:, 0])
        vol_sq = vol_sum**2
        counts = feats.new_ones((B, D, hp, wp, 1))
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
            counts = counts + valid.to(counts.dtype).reshape(B, D, hp, wp, 1)
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
        xy = geometry.flat_idx_to_xy(ray_idx, W).to(near.dtype)
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
            masks.append(((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).to(pts.dtype))
            xs.append(x)
            ys.append(y)
        return torch.stack(xs, 1).reshape(B * V, -1), torch.stack(ys, 1).reshape(B * V, -1), \
            torch.stack(masks, 1)

    def volume_lookup(self, volume, vox_xyz, samples_per_ray: int) -> torch.Tensor:
        """Trilinear lookup of the encoding volume, (B, P, 8): kernel #6 at
        bf16 in eval mode; in train mode its plain version in f32 under
        autograd, as JAX trains through its XLA gather (the kernel has no
        backward)."""
        if self.training:
            return tri_sample_plain(volume, vox_xyz, samples_per_ray)
        return fused_tri_sample(volume, vox_xyz, samples_per_ray)

    def radiance(self, uvd, feat, dirs) -> torch.Tensor:
        """The head on raw NDC coordinates (encoded on the way), (B, P, 4):
        for a ``KERNEL_HEADS`` head in eval mode the renderer-MLP kernel
        (#8); otherwise the head's plain version, differentiable."""
        head = self.nerf.nerf
        if self.training or self.cfg.net_type not in KERNEL_HEADS:
            return head(uvd, feat, dirs, self.cfg.pos_freqs)
        return fused_renderer_mlp(head.mlp_params(), uvd, feat, dirs, self.cfg.pos_freqs)

    def render_stages(self, batch, volume, ray_idx, near, far):
        """The render up to its head: samples, the volume lookup
        (``volume_lookup``) and the colour lookup (kernel #3 in both modes).
        Returns the lookups' arguments as this render passes them
        ({'tri_sample', 'img_sample'}), the head's inputs (uvd (B, R*D, 3),
        feat (B, R*D, 8+4V), dirs (B, R*D, 3)), the samples (B, R, D, 3) and
        their z values (B, R, D)."""
        B, V, H, W = batch["src_inps"].shape[:4]
        world_xyz, ray_d, z_vals = self.sample_points(batch, ray_idx, near, far)
        R, D = z_vals.shape[1:]
        pts = world_xyz.reshape(B, -1, 3)
        uvd, vox_xyz = self.volume_coords(batch, volume, pts, near, far)
        x, y, masks = self.view_colors(batch, pts)
        rgbs = render.unpreprocess(batch["src_inps"]).reshape(B * V, H, W, 3)
        calls = {"tri_sample": (volume, vox_xyz, D), "img_sample": (rgbs, x, y, "border")}
        vox = self.volume_lookup(*calls["tri_sample"])
        col = fused_row_sample(*calls["img_sample"]).reshape(B, V, -1, 3)
        feat = torch.cat([vox, torch.cat([col, masks[..., None]], -1).movedim(1, 2)
                          .reshape(B, R * D, 4 * V)], dim=-1)  # [vox 8, (rgb, mask) per view]
        dirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        dirs = dirs @ batch["src_exts"][:, 0, :3, :3].transpose(-1, -2)  # reference frame
        dirs = dirs[:, :, None, :].expand(B, R, D, 3).reshape(B, R * D, 3)
        return calls, (uvd.contiguous(), feat, dirs), world_xyz, z_vals

    def render_volume(self, batch, volume, ray_idx, near, far, with_mask: bool = True) -> dict:
        """Raw per-sample outputs {'net_output' (B, R, D, 4), 'z_vals'
        (B, R, D)[, 'mask' (B, R, D), without gradient]}."""
        _, head_in, world_xyz, z_vals = self.render_stages(batch, volume, ray_idx, near, far)
        out = {"net_output": self.radiance(*head_in).reshape(*z_vals.shape, 4), "z_vals": z_vals}
        if with_mask:
            B, _, H, W = batch["src_inps"].shape[:4]
            inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=z_vals.device)
            out["mask"] = render.mask_viewport(world_xyz, batch["src_exts"], batch["src_ixts"],
                                               inv_scale.expand(B, 2)).detach()
        return out

    def near_far(self, depth_ranges: torch.Tensor):
        """Scene bounds of each batch entry from its views' depth ranges
        (B, V, 2), widened by ``near_far_scale``: (near (B,), far (B,))."""
        s = self.cfg.near_far_scale
        return depth_ranges[..., 0].amin(1) * s[0], depth_ranges[..., 1].amax(1) * s[1]

    def render(self, batch: dict) -> dict:
        """The forward on a batch of tensors on the model's device
        (``to_tensors``), in the module's mode. Differentiable. The first
        ``n_views`` source views build the volume; the feature net runs
        over all of them, as in JAX (train-mode BatchNorm sees them all)."""
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

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """The render of a batch (numpy arrays or tensors) without
        gradients; the eval render after ``model.eval()``."""
        return self.render(to_tensors(batch, self.device))
