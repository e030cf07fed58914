"""The ENeRF variants (counterpart of ``boostmvsnerfs_tpu/models/variants.py``):
the layered foreground/background composite and the masked human cascade.

* ``CompositeENeRF`` (reference lib/networks/enerf/network_composite.py):
  per foreground layer a cascade over a crop camera of static size
  ``fg_hw`` whose principal point moves by the layer's bbox origin
  (MinCostRegNet at every level and the image-feature-only head), one FPN
  shared by the layers; a full-frame background cascade with its own FPN
  and the voxel head. Each rendered level scatters the layers' raw samples
  into the full raster, sorts them by depth and merges them with the
  background's into one transmittance integral (``composite_outputs``).
* ``HumanENeRF`` (reference network_human.py): the standard cascade with
  the last level's rgb zeroed outside ``mask_at_box`` in eval mode.

Batch extras (numpy arrays or tensors, as the JAX package takes them):
  bbox          (B, L, 2|4) int  per-layer crop origins (x, y) at full
                resolution; multiples of 1 / min(volume_scale) keep the
                crop's volume and render rasters on whole pixels
  near_far      (B, L+1, 2)      per-layer depth ranges, the last the bg's
  bg_src_inps   (B, S, H, W, 3)  optional clean plates for the bg render
  mask_at_box   (B, H, W)        the human variant's foreground mask
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.models.enerf import CascadeConfig, ENeRF, to_tensors
from boostmvsnerfs_torch.ops import render


def _shift_ppoint(ixt: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """The crop camera: the principal point moved so that crop pixel (0, 0)
    images the ray of full-frame pixel (x0, y0)."""
    shift = torch.zeros_like(ixt)
    shift[:, 0, 2], shift[:, 1, 2] = x0, y0
    return ixt - shift


def _scatter_full(update: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                  H: int, W: int) -> torch.Tensor:
    """Crop tensors (B, h, w, ...) placed into zeros (B, H, W, ...) at
    per-batch origins (y0, x0), each clamped so that the crop fits, as
    ``jax.lax.dynamic_update_slice`` clamps its start. Differentiable."""
    B, h, w = update.shape[:3]
    rest = update.shape[3:]
    ys = y0.clamp(0, H - h)[:, None] + torch.arange(h, device=update.device)
    xs = x0.clamp(0, W - w)[:, None] + torch.arange(w, device=update.device)
    idx = (ys[:, :, None] * W + xs[:, None, :]).reshape(B, h * w, *([1] * len(rest)))
    src = update.reshape(B, h * w, *rest)
    full = update.new_zeros((B, H * W, *rest))
    return full.scatter(1, idx.expand(B, h * w, *rest), src).reshape(B, H, W, *rest)


def composite_outputs(fg_layers: list, bg_layer: dict, origins_r: torch.Tensor,
                      crop_hw: tuple, full_hw: tuple, white_bkgd: bool = False) -> dict:
    """The foreground layers' samples ({'net_output': (B, h*w, Ns, 4),
    'z_vals': (B, h*w, Ns)} each) scattered into the full raster at the
    render-scale origins ``origins_r`` (B, L, 2) (x, y), sorted by depth
    across layers (stable: outside every crop the layers tie at z = 0),
    then the background's samples appended, in one volume-rendering
    integral. The depth is the plain expectation (no softmax) over z
    without gradient; ``white_bkgd`` adds 1 - acc to the rgb."""
    H, W = full_hw
    h, w = crop_hw
    raws, zs = [], []
    for li, lay in enumerate(fg_layers):
        B, _, Ns, _ = lay["net_output"].shape
        y0, x0 = origins_r[:, li, 1], origins_r[:, li, 0]
        raw = _scatter_full(lay["net_output"].reshape(B, h, w, Ns, 4), y0, x0, H, W)
        z = _scatter_full(lay["z_vals"].reshape(B, h, w, Ns), y0, x0, H, W)
        raws.append(raw.reshape(B, H * W, Ns, 4))
        zs.append(z.reshape(B, H * W, Ns))
    net, z = torch.cat(raws, dim=-2), torch.cat(zs, dim=-1)
    if len(fg_layers) > 1:
        z, order = torch.sort(z, dim=-1, stable=True)
        net = torch.gather(net, -2, order[..., None].expand(*order.shape, 4))
    net = torch.cat([net, bg_layer["net_output"]], dim=-2)
    z = torch.cat([z, bg_layer["z_vals"]], dim=-1)
    out = render.composite(net, z, softmax_depth=False)
    if white_bkgd:
        out["rgb"] = out["rgb"] + (1.0 - out["weights"].sum(-1, keepdim=True))
    return out


def _metric_z(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Depth for the cross-layer sort: inverse-depth levels inverted."""
    return 1.0 / z.clamp_min(1e-6) if inverse else z


class CompositeENeRF(nn.Module):
    """Layered foreground/background cascade. Parameter names: ``fg_{l}.*``
    per foreground layer (only ``fg_0`` has a ``feature_net``: the layers
    share one FPN, and the flax module creates parameters only for what it
    calls) and ``bg.*``. ``fg_hw`` is the static full-resolution crop size,
    a multiple of 4 / min(volume_scale) so that the crop's volume suits the
    U-Nets. Runs on CUDA unless ``device`` says otherwise. Built in eval
    mode."""

    def __init__(self, cas: CascadeConfig = CascadeConfig(), num_fg_layers: int = 1,
                 fg_hw: tuple = (64, 64), bg_planes: tuple = (16, 4), white_bkgd: bool = False,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cas, self.num_fg_layers = cas, num_fg_layers
        self.fg_hw, self.white_bkgd = tuple(fg_hw), white_bkgd
        fg_cas = dataclasses.replace(cas, min_cost_reg_all=True, use_vox_feat=False)
        for li in range(num_fg_layers):
            setattr(self, f"fg_{li}", ENeRF(fg_cas, device, feature_net=li == 0))
        self.bg = ENeRF(dataclasses.replace(cas, volume_planes=tuple(bg_planes),
                                            min_cost_reg_all=True), device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def fg(self, li: int) -> ENeRF:
        return getattr(self, f"fg_{li}")

    def render(self, batch: dict) -> dict:
        """``{rgb, depth, weights}_level{i}`` of every rendered level over the
        full raster, from a batch of tensors on the model's device, in the
        module's mode. Differentiable."""
        cas = self.cas
        B, _, H, W, _ = batch["src_inps"].shape
        feats_fg = self.fg(0).extract_features(batch["src_inps"])
        bg_inps = batch.get("bg_src_inps", batch["src_inps"])
        feats_bg = self.bg.extract_features(bg_inps)
        origins = batch["bbox"][..., :2].long()  # (B, L, 2) x, y
        h, w = self.fg_hw
        views = (batch["src_exts"], batch["src_ixts"], batch["tar_ext"])
        ret = {}
        prev_fg, prev_bg = [None] * self.num_fg_layers, None
        for i in range(cas.num):
            r_s = cas.render_scale[i]
            h_r, w_r = int(h * r_s), int(w * r_s)
            fg_layers = []
            for li in range(self.num_fg_layers):
                fg = self.fg(li)
                tar_ixt = _shift_ppoint(batch["tar_ixt"], origins[:, li, 0].float(),
                                        origins[:, li, 1].float())
                feat_vol, depth, std, nf_map = fg.build_level_volume(
                    i, feats_fg, *views, tar_ixt, batch["near_far"][:, li], prev_fg[li],
                    tar_hw=(h, w))
                prev_fg[li] = (depth, std, nf_map)
                if not cas.render_if[i]:
                    continue
                ray_idx = torch.arange(h_r * w_r, device=tar_ixt.device).expand(B, -1)
                raw = fg.render_level(i, feats_fg, feat_vol, depth, std, nf_map,
                                      {**batch, "tar_ixt": tar_ixt}, ray_idx, return_raw=True,
                                      tar_hw=(h, w))
                fg_layers.append({"net_output": raw["net_output"],
                                  "z_vals": _metric_z(raw["z_vals"], cas.depth_inv[i])})

            feat_vol, depth, std, nf_map = self.bg.build_level_volume(
                i, feats_bg, *views, batch["tar_ixt"], batch["near_far"][:, -1], prev_bg)
            prev_bg = (depth, std, nf_map)
            if not cas.render_if[i]:
                continue
            H_r, W_r = int(H * r_s), int(W * r_s)
            ray_idx = torch.arange(H_r * W_r, device=feat_vol.device).expand(B, -1)
            raw = self.bg.render_level(i, feats_bg, feat_vol, depth, std, nf_map,
                                       {**batch, "src_inps": bg_inps}, ray_idx, return_raw=True)
            bg_layer = {"net_output": raw["net_output"],
                        "z_vals": _metric_z(raw["z_vals"], cas.depth_inv[i])}
            origins_r = (origins.float() * r_s).long()  # truncated toward zero, as JAX's int32
            out = composite_outputs(fg_layers, bg_layer, origins_r, (h_r, w_r), (H_r, W_r),
                                    self.white_bkgd)
            ret.update({f"{k}_level{i}": v for k, v in out.items()})
        return ret

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """The render of a batch (numpy arrays or tensors) without
        gradients; the eval render after ``model.eval()``."""
        return self.render(to_tensors(batch, self.device))


class HumanENeRF(ENeRF):
    """Masked-subject cascade: ENeRF, with the last level's rgb zeroed
    outside the batch's ``mask_at_box`` in eval mode (the reference gathers
    the rays inside the mask and scatters their rgb into a zero canvas:
    the same values)."""

    def render(self, batch: dict) -> dict:
        ret = super().render(batch)
        key = f"rgb_level{self.cas.num - 1}"
        if "mask_at_box" in batch and not self.training and key in ret:
            mask = batch["mask_at_box"].reshape(ret[key].shape[0], -1, 1)
            ret[key] = ret[key] * mask.to(ret[key].dtype)
        return ret
