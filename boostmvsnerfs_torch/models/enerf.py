"""ENeRF backbone: cascade cost volumes + depth-guided radiance rendering
(counterpart of ``boostmvsnerfs_tpu/models/enerf.py``, eval and training).

Batch convention (numpy arrays or tensors, JAX layouts):
  src_inps   (B, S, H, W, 3)  source images in [-1, 1]
  src_exts   (B, S, 4, 4)     world->camera
  src_ixts   (B, S, 3, 3)
  tar_ext    (B, 4, 4)
  tar_ixt    (B, 3, 3)
  near_far   (B, 2)           scene-level depth range
  ray_idx_{i} (B, N_i)        flat pixel ids at level-i render scale

The three hot loops go through ``ops.cuda``: the cost volume
(``fused_warp_variance``), the per-view feature sampling
(``fused_row_sample``) and the head (``NeRFHead``). Each runs its CUDA
kernel on a CUDA device and its plain PyTorch version on the CPU. The
module's own mode takes the place of the JAX module's ``train`` argument:
after ``model.train()`` the stages use the differentiable warp and sampler
(forward and backward kernels), the plain head (the head kernel has no
backward, in JAX either) and batch-statistics BatchNorm; after
``model.eval()`` the forward kernels, the head kernel and the running
statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.models.cost_reg_net import CostRegNet, MinCostRegNet
from boostmvsnerfs_torch.models.feature_net import FeatureNet
from boostmvsnerfs_torch.models.nerf_head import NeRFHead
from boostmvsnerfs_torch.ops import cost_volume, geometry, render, sampling
from boostmvsnerfs_torch.ops.cuda.img_sample import fused_row_sample, fused_row_sample_diff
from boostmvsnerfs_torch.ops.cuda.warp_variance import (
    fused_warp_variance,
    fused_warp_variance_diff,
)
from boostmvsnerfs_torch.utils.profiling import count, spanned

# channels of the FPN's level_0/1/2 maps, the cost-volume inputs per level
FPN_CHANNELS = (32, 16, 8)
WARP_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# computation type of the FPN's and the cost-regularisation nets'
# convolutions and batch norms (``models/blocks.py``); None: the parameters'
CONV_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# the JAX CascadeConfig's TPU implementation knobs (Pallas, windowed and
# structured paths, their windows and tilings), which ``from_cfg`` drops
TPU_KNOBS = ("warp_mode", "warp_window_h", "warp_rows_per_tile", "pallas_window_h",
             "warp_cols_per_tile", "warp_window_w", "eval_sampling", "eval_head",
             "img_window_h", "pallas_img_window_h", "pallas_img_window_w",
             "pallas_img_chunk_bands", "img_cols_per_tile", "img_window_w",
             "warp_remat_planes")


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade settings that change the math (reference
    configs/exps/pretrain/enerf/dtu_pretrain.yaml, enerf_ours for the boost
    fields). The JAX config's TPU-only knobs (Pallas/windowed/structured
    paths, windows, tilings) have no counterpart."""

    num: int = 2
    depth_inv: tuple = (True, False)
    volume_scale: tuple = (0.125, 0.5)
    volume_planes: tuple = (64, 8)
    im_feat_scale: tuple = (0.25, 0.5)
    im_ibr_scale: tuple = (0.25, 1.0)
    render_scale: tuple = (0.25, 1.0)
    render_im_feat_level: tuple = (0, 2)
    nerf_model_feat_ch: tuple = (32, 8)
    render_if: tuple = (True, True)
    num_samples: tuple = (8, 2)
    # training: random rays per level, and patches of patch_size^2 pixels
    # appended to them, mask-weighted ray sampling (read by the data's
    # train split; the port's training renders full images)
    num_rays: tuple = (4096, 32768)
    num_patchs: tuple = (0, 0)
    patch_size: tuple = (-1, -1)
    sample_on_mask: bool = False
    # training: levels that train on full images, and each level's weight
    # in the loss
    train_img: tuple = (True, True)
    loss_weight: tuple = (0.1, 1.0)
    viewdir_agg: bool = True
    k_best: int = 4
    cost_volume_input_views: int = 3
    # operands of the eval plane-sweep warp on the card (JAX's default):
    # "bfloat16" rounds the features and tap weights to bf16 and sums in
    # float32; "float32" runs the f32 kernel. Training warps in float32.
    warp_dtype: str = "bfloat16"
    # computation type of the FPN's and both cost-regularisation nets'
    # convolutions and batch norms (JAX's ``conv_dtype``, the reference AMP
    # trainer's autocast): "bfloat16" computes them in bf16 with float32
    # parameters, statistics and outputs
    conv_dtype: str = "float32"
    # MinCostRegNet at every level (not only the first), and the head
    # without voxel features (lr0 over the pooled image feature alone): the
    # layered composite variant's per-layer stack
    min_cost_reg_all: bool = False
    use_vox_feat: bool = True

    def __post_init__(self):
        if self.warp_dtype not in WARP_DTYPES:
            raise ValueError(f"warp_dtype {self.warp_dtype!r} not in {sorted(WARP_DTYPES)}")
        if self.conv_dtype not in CONV_DTYPES:
            raise ValueError(f"conv_dtype {self.conv_dtype!r} not in {sorted(CONV_DTYPES)}")

    @staticmethod
    def from_cfg(node) -> "CascadeConfig":
        """Build from a cfg ``enerf`` subtree, as the JAX ``from_cfg`` does.
        The JAX config's TPU knobs (``TPU_KNOBS``) are dropped by name; a
        key no config knows raises."""
        cas = node["cas_config"]
        fields = {f.name for f in dataclasses.fields(CascadeConfig)}
        kw = {}
        for k, v in cas.items():
            if k in fields:
                kw[k] = tuple(v) if isinstance(v, list) else v
            elif k not in TPU_KNOBS:
                raise ValueError(f"cas_config.{k}: unknown setting")
        for k in ("viewdir_agg", "cost_volume_input_views", "sample_on_mask"):
            if k in node:  # these live at the enerf level of the tree
                kw[k] = node[k]
        return CascadeConfig(**kw)


def to_tensors(batch: dict, device: torch.device, dtype=torch.float32) -> dict:
    """A batch of numpy arrays or tensors on ``device``: floats as ``dtype``
    (the model's), integers as int64 (index tensors). The bytes that cross
    from host memory to another device add to the ``h2d_bytes`` counter
    (``utils/profiling``), after the cast: a blocking copy casts on the
    host."""
    to_host = torch.device(device).type == "cpu"
    out = {}
    sent = 0
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        target = dtype if t.is_floating_point() else torch.int64
        if not to_host and t.device.type == "cpu":
            sent += t.numel() * target.itemsize
        out[k] = t.to(device, target)
    if sent:
        count("h2d_bytes", sent)
    return out


class ENeRF(nn.Module):
    """Cascade ENeRF network. Parameter names follow the reference
    (``feature_net.*``, ``cost_reg_{i}.*``, ``nerf_{i}.*``). Runs on CUDA
    unless ``device`` says otherwise. Built in eval mode. Without
    ``feature_net`` the cascade has no FPN of its own and its stages take
    another's features (the layered composite's foreground layers after
    the first)."""

    def __init__(self, cas: CascadeConfig = CascadeConfig(), device=None,
                 feature_net: bool = True):
        super().__init__()
        self.cas = cas
        dtype = CONV_DTYPES[cas.conv_dtype]
        if feature_net:
            self.feature_net = FeatureNet(dtype)
        for i in range(cas.num):
            reg = MinCostRegNet if i == 0 or cas.min_cost_reg_all else CostRegNet
            setattr(self, f"cost_reg_{i}", reg(FPN_CHANNELS[i], dtype))
            setattr(self, f"nerf_{i}", NeRFHead(cas.nerf_model_feat_ch[i] + 3,
                                                viewdir_agg=cas.viewdir_agg,
                                                use_vox_feat=cas.use_vox_feat))
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    @spanned("model.features")
    def extract_features(self, src_inps: torch.Tensor) -> dict:
        """FPN over all source views: {'level_k': (B, S, h, w, c)}."""
        B, S = src_inps.shape[:2]
        feats = self.feature_net(src_inps.reshape(B * S, *src_inps.shape[2:]))
        return {k: v.reshape(B, S, *v.shape[1:]) for k, v in feats.items()}

    def volume_inputs(self, level, feats, src_exts, src_ixts, tar_ext, tar_ixt,
                      near_far, prev, tar_hw=None):
        """The plane sweep's inputs at ``level``: depth hypotheses
        (B, D, Hv, Wv), their bounds map (B, 2, Hv, Wv) and the projection
        matrices (B, S, 3, 4). ``prev`` is None or the previous level's
        (depth, std, bounds map). ``tar_hw`` is the target raster's
        full-resolution size when it differs from the source views' (a
        crop camera of the layered composite); by default the views'."""
        cas = self.cas
        if tar_hw is None:
            Hf, Wf = feats[f"level_{level}"].shape[2:4]
            H = int(round(Hf / cas.im_feat_scale[level]))
            W = int(round(Wf / cas.im_feat_scale[level]))
        else:
            H, W = tar_hw
        Hv, Wv = int(H * cas.volume_scale[level]), int(W * cas.volume_scale[level])
        D = cas.volume_planes[level]
        inv = cas.depth_inv[level]
        if prev is None:
            dv = cost_volume.initial_depth_values(near_far, D, Hv, Wv, inv)
        else:
            depth_p, std_p, nf_p = prev
            dv = cost_volume.refined_depth_values(
                depth_p, std_p, nf_p, D, Hv, Wv, cas.depth_inv[level - 1], inv
            )
        pm = geometry.proj_mats(
            src_ixts, src_exts, tar_ixt, tar_ext,
            src_scale=cas.im_feat_scale[level], tar_scale=cas.volume_scale[level],
        )
        return dv, cost_volume.depth_values_near_far(dv, inv), pm.contiguous()

    @spanned("model.volume")
    def build_level_volume(self, level, feats, src_exts, src_ixts, tar_ext, tar_ixt,
                           near_far, prev, tar_hw=None):
        """Cost volume -> regularised feature volume and regressed depth:
        (feat_vol (B, D, Hv, Wv, 8), depth (B, Hv, Wv), std, nf_map). In
        train mode the warp is differentiable (kernels #1 and #2, float32);
        in eval mode it runs at ``cas.warp_dtype``. ``tar_hw`` as in
        ``volume_inputs``."""
        dv, nf_map, pm = self.volume_inputs(
            level, feats, src_exts, src_ixts, tar_ext, tar_ixt, near_far, prev, tar_hw
        )
        if self.training:
            vol = fused_warp_variance_diff(feats[f"level_{level}"], pm, dv)
        else:
            vol = fused_warp_variance(feats[f"level_{level}"], pm, dv,
                                      WARP_DTYPES[self.cas.warp_dtype])
        feat_vol, logits = getattr(self, f"cost_reg_{level}")(vol)
        depth, std = render.depth_regression(logits, dv, self.cas.depth_inv[level])
        return feat_vol, depth, std, nf_map

    def level_maps(self, level, feats, depth, std, nf_map, src_inps, tar_hw=None) -> tuple:
        """The ray-independent inputs of a level's render: the per-pixel ray
        bounds of the target raster (B, H_r, W_r, 4), ``tar_hw`` (default:
        the source views' size) at render scale, and each view's image
        features + RGB at render scale (B, S, Hs_r, Ws_r, C+3)."""
        cas = self.cas
        H, W = src_inps.shape[2:4] if tar_hw is None else tar_hw
        rs = cas.render_scale[level]
        bounds_map = render.ray_bounds_maps(depth, std, nf_map, int(H * rs), int(W * rs),
                                            cas.depth_inv[level])
        return bounds_map, self.view_maps(level, feats, src_inps)

    def sample_rays(self, level, bounds_map, batch, ray_idx):
        """Depth-guided samples of the rays at ``ray_idx`` (B, N) within
        ``bounds_map`` (B, H_r, W_r, 4): (world_xyz (B, N, Ns, 3), uvd
        (B, N, Ns, 3), z_vals (B, N, Ns))."""
        cas = self.cas
        B, H_r, W_r = bounds_map.shape[:3]
        bounds = torch.gather(bounds_map.reshape(B, H_r * W_r, 4), 1,
                              ray_idx[..., None].expand(-1, -1, 4))
        xy = geometry.flat_idx_to_xy(ray_idx, W_r).to(bounds_map.dtype)
        ray_o, ray_d = geometry.rays_from_pixels(
            geometry.scale_ixt(batch["tar_ixt"], cas.render_scale[level]), batch["tar_ext"], xy
        )
        return render.sample_along_depth(ray_o, ray_d, bounds, xy, cas.num_samples[level],
                                         cas.depth_inv[level])

    def voxel_features(self, feat_vol, uvd, H_r: int, W_r: int) -> torch.Tensor:
        """Trilinear lookup of the feature volume at the samples' volume
        coordinates (uv normalised over the render frame): (B, N*Ns, 8)."""
        B = feat_vol.shape[0]
        D, Hv, Wv = feat_vol.shape[1:4]
        u = uvd[..., 0] / (W_r - 1) * (Wv - 1)
        v = uvd[..., 1] / (H_r - 1) * (Hv - 1)
        d = uvd[..., 2] * (D - 1)
        xyz = torch.stack([u, v, d], dim=-1).reshape(B, -1, 3)
        return sampling.grid_sample_3d(feat_vol, xyz, "zeros")

    def view_maps(self, level, feats, src_inps) -> torch.Tensor:
        """Per-view image features + RGB at render scale, (B, S, H_r, W_r, C+3)."""
        cas = self.cas
        im_feat = feats[f"level_{cas.render_im_feat_level[level]}"]
        up = cas.render_scale[level] / cas.im_ibr_scale[level]
        if up != 1.0:
            im_feat = sampling.resize_bilinear(
                im_feat, int(im_feat.shape[-3] * up), int(im_feat.shape[-2] * up)
            )
        rgbs = render.unpreprocess(src_inps, cas.render_scale[level])
        return torch.cat([im_feat, rgbs], dim=-1)

    def project_to_views(self, pts, batch, render_scale: float):
        """Source-pixel (x, y) of points (B, P, 3) in every source view at
        ``render_scale``, each (B, S, P)."""
        xs, ys = [], []
        for s in range(batch["src_exts"].shape[1]):
            ixt = geometry.scale_ixt(batch["src_ixts"][:, s], render_scale)
            xy, _ = geometry.project_points(pts, batch["src_exts"][:, s], ixt)
            xs.append(xy[..., 0])
            ys.append(xy[..., 1])
        return torch.stack(xs, 1), torch.stack(ys, 1)

    @staticmethod
    def ray_diff_dirs(pts, batch) -> torch.Tensor:
        """Ray-difference descriptors (unit direction of tar-ray minus
        src-ray, and their dot product) per view: (B, S, P, 4)."""
        tar_c = geometry.cam_center(batch["tar_ext"])  # (B, 3)
        tar_diff = pts - tar_c[:, None]
        tar_diff = tar_diff / (torch.linalg.norm(tar_diff, dim=-1, keepdim=True) + 1e-6)
        dirs = []
        for s in range(batch["src_exts"].shape[1]):
            src_diff = pts - geometry.cam_center(batch["src_exts"][:, s])[:, None]
            src_diff = src_diff / (torch.linalg.norm(src_diff, dim=-1, keepdim=True) + 1e-6)
            ray_diff = tar_diff - src_diff
            ray_diff_norm = torch.linalg.norm(ray_diff, dim=-1, keepdim=True)
            ray_diff_dot = torch.sum(tar_diff * src_diff, dim=-1, keepdim=True)
            dirs.append(torch.cat([ray_diff / ray_diff_norm.clamp_min(1e-6), ray_diff_dot], -1))
        return torch.stack(dirs, dim=1)

    def _gather_view_features(self, world_xyz, img_feat_rgb, batch, render_scale: float):
        """Project every sample into every source view and sample features +
        RGB there (border padding), plus the ray-difference descriptors.
        Any ray set works (gather semantics). In train mode the sampler is
        differentiable (kernels #3 and #4): gradients reach the maps and,
        through the projected coordinates, the samples' depths. Returns
        S-major (feat (B, S, N*Ns, C+3), dirs (B, S, N*Ns, 4))."""
        B, S, Hf, Wf, Cf = img_feat_rgb.shape
        pts = world_xyz.reshape(B, -1, 3)
        x, y = self.project_to_views(pts, batch, render_scale)
        sample = fused_row_sample_diff if self.training else fused_row_sample
        feat = sample(
            img_feat_rgb.reshape(B * S, Hf, Wf, Cf),
            x.reshape(B * S, -1), y.reshape(B * S, -1), "border",
        ).reshape(B, S, -1, Cf)
        return feat, self.ray_diff_dirs(pts, batch)

    def render_rays(self, level, maps, feat_vol, batch, ray_idx,
                    return_raw: bool = False) -> dict:
        """Depth-guided rendering of the rays at ``ray_idx`` from a level's
        ``level_maps``. With ``return_raw`` the per-sample radiance, z values
        and visibility mask come back un-composited, for the boost blend;
        the mask carries no gradient. The target raster is the bounds map's
        (``level_maps``' ``tar_hw``). A head without voxel features takes no
        voxel lookup."""
        cas = self.cas
        bounds_map, img_feat_rgb = maps
        B, H_r, W_r = bounds_map.shape[:3]
        world_xyz, uvd, z_vals = self.sample_rays(level, bounds_map, batch, ray_idx)
        N, Ns = world_xyz.shape[1:3]
        vox = self.voxel_features(feat_vol, uvd, H_r, W_r) if cas.use_vox_feat else None
        feat, dirs = self._gather_view_features(world_xyz, img_feat_rgb, batch,
                                                cas.render_scale[level])
        raw = getattr(self, f"nerf_{level}")(vox, feat, dirs).reshape(B, N, Ns, 4)
        if return_raw:
            inv_scale = torch.tensor([W_r - 1, H_r - 1], dtype=torch.float32,
                                     device=raw.device).expand(B, 2)
            mask = render.mask_viewport(world_xyz, batch["src_exts"], batch["src_ixts"], inv_scale)
            return {"net_output": raw, "z_vals": z_vals, "mask": mask.detach()}
        return render.composite(raw, z_vals)

    @spanned("model.render")
    def render_level(self, level, feats, feat_vol, depth, std, nf_map, batch, ray_idx,
                     return_raw: bool = False, tar_hw=None) -> dict:
        """``render_rays`` after ``level_maps`` (``tar_hw`` as there);
        composited outputs also carry the level's regressed depth
        (``depth_mvs``) and ``std``."""
        maps = self.level_maps(level, feats, depth, std, nf_map, batch["src_inps"], tar_hw)
        out = self.render_rays(level, maps, feat_vol, batch, ray_idx, return_raw)
        if not return_raw:
            out["depth_mvs"] = 1.0 / depth if self.cas.depth_inv[level] else depth
            out["std"] = std
        return out

    # ------------------------------------------------------------------
    # full forward
    # ------------------------------------------------------------------

    def render(self, batch: dict) -> dict:
        """The full forward on a batch of tensors on the model's device
        (``to_tensors``), in the module's mode. Differentiable."""
        feats = self.extract_features(batch["src_inps"])
        ret = {}
        prev = None
        for i in range(self.cas.num):
            feat_vol, depth, std, nf_map = self.build_level_volume(
                i, feats, batch["src_exts"], batch["src_ixts"], batch["tar_ext"],
                batch["tar_ixt"], batch["near_far"], prev,
            )
            prev = (depth, std, nf_map)
            if not self.cas.render_if[i]:
                continue
            out = self.render_level(i, feats, feat_vol, depth, std, nf_map, batch,
                                    batch[f"ray_idx_{i}"])
            ret.update({f"{k}_level{i}": v for k, v in out.items()})
        return ret

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """The render of a batch (numpy arrays or tensors) without
        gradients; the eval render after ``model.eval()``."""
        return self.render(to_tensors(batch, self.device))
