"""Kernel 3: the whole ENeRF IBR head per sample.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/enerf_head.py::
fused_nerf_head``; the CUDA source is ``csrc/enerf_head.cu``. Inputs are
S-major, as the sampler (kernel 2) produces them: its (B*S, P, C) output
reshapes to (B, S, P, C) at no cost.

``params`` maps each layer name of ``HEAD_LAYERS`` to its (weight, bias)
in ``nn.Linear`` layout (out, in); ``view_fc`` is absent when the head has
no view-direction conditioning.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from boostmvsnerfs_torch.ops.cuda import _build

NAME = "enerf_head"
HEAD_LAYERS = ("view_fc", "global_fc", "agg_w_fc", "fc", "lr0", "sigma", "color0", "color1")
# (S, C) pairs instantiated in csrc/enerf_head.cu
SUPPORTED = {(3, 11), (3, 35)}
HID = 64
_BLOCK = 128
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log1p(exp(-|x|)) + max(x, 0)``, as ``jax.nn.softplus`` computes it."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def nerf_head_plain(
    params: dict, vox: torch.Tensor, feat: torch.Tensor, dirs: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: vox (B, P, 8), feat (B, S, P, C),
    dirs (B, S, P, 4) -> raw (rgb, sigma) (B, P, 4)."""
    f0 = feat.movedim(1, 2)  # (B, P, S, C)
    d = dirs.movedim(1, 2)  # (B, P, S, 4)
    C = f0.shape[-1]
    fs = f0 + F.relu(F.linear(d, *params["view_fc"])) if "view_fc" in params else f0
    var = fs.var(dim=-2, correction=0, keepdim=True)
    avg = fs.mean(dim=-2, keepdim=True)
    kg, bg = params["global_fc"]  # input [img (C), var (C), avg (C)]
    stat = F.linear(var, kg[:, C:2 * C]) + F.linear(avg, kg[:, 2 * C:]) + bg
    g = F.relu(F.linear(fs, kg[:, :C]) + stat)  # (B, P, S, 32)
    agg_w = torch.softmax(F.relu(F.linear(g, *params["agg_w_fc"])), dim=-2)
    img_feat = F.relu(F.linear(torch.sum(g * agg_w, dim=-2), *params["fc"]))
    vox_img = torch.cat([vox, img_feat], dim=-1)  # (B, P, 24)
    x = F.relu(F.linear(vox_img, *params["lr0"]))
    sigma = softplus(F.linear(x, *params["sigma"]))
    # color0 over [x, vox_img] (per sample) and [feat, dir] (per view)
    kc, bc = params["color0"]
    xi = torch.cat([x, vox_img], dim=-1)
    Dx = xi.shape[-1]
    base = F.linear(xi, kc[:, :Dx], bc)
    w = F.relu(base[..., None, :] + F.linear(torch.cat([f0, d], dim=-1), kc[:, Dx:]))
    color_w = torch.softmax(F.relu(F.linear(w, *params["color1"])), dim=-2)
    color = torch.sum(f0[..., -3:] * color_w, dim=-2)
    return torch.cat([color, sigma], dim=-1)


def pack_head_weights(params: dict) -> torch.Tensor:
    """Flatten the head's layers, weight then bias, in ``HEAD_LAYERS`` order:
    the kernel's shared-memory layout."""
    parts = []
    for name in HEAD_LAYERS:
        if name in params:
            w, b = params[name]
            parts += [w.reshape(-1), b.reshape(-1)]
    return torch.cat(parts).float().contiguous()


def fused_nerf_head(
    params: dict,
    vox: torch.Tensor,  # (B, P, 8)
    feat: torch.Tensor,  # (B, S, P, C) per-view features incl. RGB (last 3)
    dirs: torch.Tensor,  # (B, S, P, 4) ray-difference descriptors
) -> torch.Tensor:
    """Raw (rgb, sigma), (B, P, 4), for every sample. CPU tensors take the
    plain version."""
    if feat.device.type == "cpu":
        return nerf_head_plain(params, vox, feat, dirs)
    if feat.dim() != 4 or dirs.dim() != 4 or vox.dim() != 3:
        raise ValueError(f"{NAME}: expected vox (B,P,8), feat (B,S,P,C), dirs (B,S,P,4)")
    B, S, P, C = feat.shape
    if tuple(dirs.shape) != (B, S, P, 4) or tuple(vox.shape) != (B, P, 8):
        raise ValueError(
            f"{NAME}: shapes {tuple(vox.shape)}, {tuple(feat.shape)}, {tuple(dirs.shape)} "
            "do not agree"
        )
    if (S, C) not in SUPPORTED:
        raise ValueError(f"{NAME}: (views, channels) = {(S, C)} not in {sorted(SUPPORTED)}")
    if tuple(params["lr0"][0].shape) != (HID, 24):
        raise ValueError(f"{NAME}: the kernel takes a {HID}-wide head over 8+16 inputs")
    dev = feat.device
    weights = pack_head_weights(params)
    _build.check_inputs(NAME, dev, weights=weights, vox=vox, feat=feat, dirs=dirs)
    out = torch.empty((B, P, 4), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-B * P // _BLOCK), 4 * sms))
    fn = _build.kernel_function(NAME, "enerf_head_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(weights.data_ptr(), weights.numel(), vox.data_ptr(), feat.data_ptr(),
                dirs.data_ptr(), out.data_ptr(), B, S, P, C, int("view_fc" in params), grid,
                _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
