"""The plain versions of the port's hand-written kernels, under the kernels'
names, at the precisions the configurations state for them on the card.

The models in this package call ``fused_*`` where the port launches a CUDA
kernel. Here every such name is the kernel's plain PyTorch version (copied
from the port's ``ops/cuda`` wrappers as they stand), at the numeric
contract the kernel has on the card:

* the plane-sweep warp (#1) at the model's ``warp_dtype`` (bf16 features
  and tap weights, float32 sums) in eval mode, float32 in training;
* the row sampler (#3) in float32;
* the ENeRF head (#5) and the renderer MLP (#8) with every dense layer on
  bf16 operands and float32 sums;
* the volume sampler (#6) at bf16 operands, float32 sums.

The differentiable names (``*_diff``) are the float32 plain versions under
autograd. Inside ``kernel_precision(torch.float32)`` every kernel's plain
version runs in float32, as the port's own CPU path runs them.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F

from . import cost_volume, sampling

COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
# the precision every kernel's plain version takes; None: each kernel's own
_KERNEL_DTYPE = contextvars.ContextVar("kernel_dtype", default=None)


@contextlib.contextmanager
def kernel_precision(dtype):
    """Run every kernel's plain version at ``dtype`` inside the block."""
    token = _KERNEL_DTYPE.set(dtype)
    try:
        yield
    finally:
        _KERNEL_DTYPE.reset(token)


def _at(dtype):
    """``dtype``, unless ``kernel_precision`` sets another."""
    override = _KERNEL_DTYPE.get()
    return dtype if override is None else override


def resolve_device(device=None) -> torch.device:
    """The device a reference model is built on: the one given, else CUDA."""
    return torch.device("cuda" if device is None else device)


def check_compute_dtype(name: str, compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name}: compute_dtype must be torch.bfloat16 or torch.float32, "
                        f"got {compute_dtype}")


def dense(x: torch.Tensor, w: torch.Tensor, b=None, compute_dtype=torch.float32) -> torch.Tensor:
    """``F.linear`` with both operands rounded to ``compute_dtype`` and the
    products summed in float32 (a bf16 product is exact in float32)."""
    if compute_dtype != torch.float32:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    return F.linear(x, w, b)


# ---------------------------------------------------------------- #1, #2


def warp_variance_plain(src_feats, proj_mats, depth_values, compute_dtype=torch.float32):
    """Variance cost volume (B, D, Ht, Wt, C) over the S warped views."""
    check_compute_dtype("warp_variance", compute_dtype)
    return cost_volume.variance_volume(src_feats, proj_mats, depth_values, compute_dtype)


def fused_warp_variance(src_feats, proj_mats, depth_values, compute_dtype=torch.bfloat16):
    return warp_variance_plain(src_feats, proj_mats, depth_values, _at(compute_dtype))


def fused_warp_variance_diff(src_feats, proj_mats, depth_values):
    return warp_variance_plain(src_feats, proj_mats, depth_values)


# ---------------------------------------------------------------- #3, #4


def row_sample_plain(imgs, x, y, padding_mode: str = "border"):
    """Bilinear samples (V, P, C) of maps (V, H, W, C) at x, y (V, P)."""
    return sampling.grid_sample_2d(imgs, torch.stack([x, y], dim=-1), padding_mode)


fused_row_sample = row_sample_plain
fused_row_sample_diff = row_sample_plain


# ---------------------------------------------------------------- #5


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log1p(exp(-|x|)) + max(x, 0)``."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def nerf_head_plain(params: dict, vox, feat, dirs, compute_dtype=torch.float32):
    """The ENeRF head: vox (B, P, 8) or None, feat (B, S, P, C), dirs
    (B, S, P, 4) -> raw (rgb, sigma) (B, P, 4); with bfloat16 each dense
    layer rounds its two operands, the RGB blend stays a float32 sum."""
    check_compute_dtype("enerf_head", compute_dtype)
    lin = functools.partial(dense, compute_dtype=compute_dtype)
    f0 = feat.movedim(1, 2)  # (B, P, S, C)
    d = dirs.movedim(1, 2)  # (B, P, S, 4)
    C = f0.shape[-1]
    fs = f0 + F.relu(lin(d, *params["view_fc"])) if "view_fc" in params else f0
    var = fs.var(dim=-2, correction=0, keepdim=True)
    avg = fs.mean(dim=-2, keepdim=True)
    kg, bg = params["global_fc"]  # input [img (C), var (C), avg (C)]
    stat = lin(var, kg[:, C:2 * C]) + lin(avg, kg[:, 2 * C:]) + bg
    g = F.relu(lin(fs, kg[:, :C]) + stat)  # (B, P, S, 32)
    agg_w = torch.softmax(F.relu(lin(g, *params["agg_w_fc"])), dim=-2)
    img_feat = F.relu(lin(torch.sum(g * agg_w, dim=-2), *params["fc"]))
    vox_img = img_feat if vox is None else torch.cat([vox, img_feat], dim=-1)
    x = F.relu(lin(vox_img, *params["lr0"]))
    sigma = softplus(lin(x, *params["sigma"]))
    kc, bc = params["color0"]
    xi = torch.cat([x, vox_img], dim=-1)
    Dx = xi.shape[-1]
    base = lin(xi, kc[:, :Dx], bc)
    w = F.relu(base[..., None, :] + lin(torch.cat([f0, d], dim=-1), kc[:, Dx:]))
    color_w = torch.softmax(F.relu(lin(w, *params["color1"])), dim=-2)
    color = torch.sum(f0[..., -3:] * color_w, dim=-2)
    return torch.cat([color, sigma], dim=-1)


def fused_nerf_head(params: dict, vox, feat, dirs):
    return nerf_head_plain(params, vox, feat, dirs, _at(torch.bfloat16))


# ---------------------------------------------------------------- #6


def tri_sample_plain(vol, xyz, samples_per_ray: int = 1, compute_dtype=torch.float32):
    """Trilinear samples (B, P, C) of vol (B, D, H, W, C), zeros padding."""
    check_compute_dtype("tri_sample", compute_dtype)
    return sampling.grid_sample_3d(vol, xyz, "zeros", compute_dtype)


def fused_tri_sample(vol, xyz, samples_per_ray: int = 1, compute_dtype=torch.bfloat16):
    return tri_sample_plain(vol, xyz, samples_per_ray, _at(compute_dtype))


# ---------------------------------------------------------------- #7, #8


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x, sin(2^f x_d), cos(2^f x_d)]``, f-major, d-minor: (..., d*(1+2F))."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device)
    xs = x.repeat(*([1] * (x.dim() - 1)), n_freqs) * freqs.repeat_interleave(x.shape[-1])
    return torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)


def mlp_trunk(params: dict, pts, feat, compute_dtype=torch.float32, additive_bias=False):
    """The renderer trunk: ``pts_bias(feat)`` multiplies each ``pts_{i}``
    layer's output before its ReLU (adds with ``additive_bias``); a layer
    wider than the trunk takes ``pts`` concatenated in front."""

    def layer(x, name):
        return dense(x, *params[name], compute_dtype=compute_dtype)

    bias = layer(feat, "pts_bias")
    h = pts
    depth = sum(k.startswith("pts_") and k != "pts_bias" for k in params)
    for i in range(depth):
        h = layer(h, f"pts_{i}")
        h = F.relu(h + bias if additive_bias else h * bias)
        if params[f"pts_{i + 1}" if i + 1 < depth else "alpha"][0].shape[1] != h.shape[-1]:
            h = torch.cat([pts, h], dim=-1)
    return h


def renderer_mlp_plain(params: dict, pts, feat, dirs, encode_freqs: int = 0,
                       compute_dtype=torch.float32, additive_bias: bool = False):
    """The v0 renderer MLP: pts (B, N, 3) raw with ``encode_freqs``, feat
    (B, N, F), dirs (B, N, 3) -> raw (rgb, alpha) (B, N, 4)."""
    check_compute_dtype("renderer_mlp", compute_dtype)

    def layer(x, name):
        return dense(x, *params[name], compute_dtype=compute_dtype)

    if encode_freqs:
        pts = positional_encoding(pts, encode_freqs)
    h = mlp_trunk(params, pts, feat, compute_dtype, additive_bias)
    alpha = F.relu(layer(h, "alpha"))
    feature = layer(h, "feature")
    h = F.relu(layer(torch.cat([feature, dirs], dim=-1), "views_0"))
    rgb = torch.sigmoid(layer(h, "rgb"))
    return torch.cat([rgb, alpha], dim=-1)


def fused_renderer_mlp(params: dict, pts, feat, dirs, encode_freqs: int = 0,
                       compute_dtype=torch.bfloat16):
    return renderer_mlp_plain(params, pts, feat, dirs, encode_freqs, _at(compute_dtype))
