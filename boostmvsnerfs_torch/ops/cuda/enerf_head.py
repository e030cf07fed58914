"""Kernel #5: the whole ENeRF IBR head per sample.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/enerf_head.py::
fused_nerf_head``; the CUDA source is ``csrc/enerf_head.cu``. Inputs are
S-major, as the sampler (kernel #3) produces them: its (B*S, P, C) output
reshapes to (B, S, P, C) at no cost. The kernel takes C in ``CHANNELS``
and any view count S from 2 to its ``MAX_VIEWS``.

``params`` maps each layer name of ``HEAD_LAYERS`` to its (weight, bias)
in ``nn.Linear`` layout (out, in); ``view_fc`` is absent when the head has
no view-direction conditioning.

The kernel has the Pallas kernel's one numeric contract: every dense layer
on bf16 operands with float32 sums (the TPU's default matmul precision),
everything else in float32. ``nerf_head_plain`` computes the same with
``compute_dtype=torch.bfloat16``, and in float32 (the flax head off the
TPU) by default.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from boostmvsnerfs_torch.ops.cuda import _build
from boostmvsnerfs_torch.ops.cuda._tensor_cores import (
    check_compute_dtype,
    dense,
    packed,
    padded_rows,
)

NAME = "enerf_head"
HEAD_LAYERS = ("view_fc", "global_fc", "agg_w_fc", "fc", "lr0", "sigma", "color0", "color1")
# channel counts instantiated in csrc/enerf_head.cu: the level-1 (8 + RGB)
# and level-0 (32 + RGB) maps
CHANNELS = (11, 35)
HID = 64
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log1p(exp(-|x|)) + max(x, 0)``, as ``jax.nn.softplus`` computes it."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def nerf_head_plain(
    params: dict, vox: torch.Tensor, feat: torch.Tensor, dirs: torch.Tensor,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """The plain PyTorch version: vox (B, P, 8), feat (B, S, P, C),
    dirs (B, S, P, 4) -> raw (rgb, sigma) (B, P, 4). With bfloat16 each
    dense layer rounds its two operands: view_fc, the three parts of
    global_fc, agg_w_fc, fc, lr0, sigma, color0's two parts and color1. The
    RGB blend stays an exact float32 sum."""
    check_compute_dtype(NAME, compute_dtype)
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
    vox_img = torch.cat([vox, img_feat], dim=-1)  # (B, P, 24)
    x = F.relu(lin(vox_img, *params["lr0"]))
    sigma = softplus(lin(x, *params["sigma"]))
    # color0 over [x, vox_img] (per sample) and [feat, dir] (per view)
    kc, bc = params["color0"]
    xi = torch.cat([x, vox_img], dim=-1)
    Dx = xi.shape[-1]
    base = lin(xi, kc[:, :Dx], bc)
    w = F.relu(base[..., None, :] + lin(torch.cat([f0, d], dim=-1), kc[:, Dx:]))
    color_w = torch.softmax(F.relu(lin(w, *params["color1"])), dim=-2)
    color = torch.sum(f0[..., -3:] * color_w, dim=-2)
    return torch.cat([color, sigma], dim=-1)


def _k16(n: int) -> int:
    return 16 * math.ceil(n / 16)


def _head_layout(params: dict, rnd) -> tuple[torch.Tensor, torch.Tensor]:
    """``pack_head_weights``'s two buffers before the matrices are cast to
    bf16, for ``packed``; ``rnd`` rounds values to bf16."""
    kg = params["global_fc"][0]
    C = kg.shape[1] // 3
    CP, CV = _k16(C), _k16(C + 4)
    kc, bc = params["color0"]
    Dx = kc.shape[1] - C - 4
    mats = []
    if "view_fc" in params:
        mats.append(padded_rows(params["view_fc"][0], CP, 16, [((0, 4), 0)]))
    mats += [padded_rows(kg, 32, 3 * CP, [((i * C, (i + 1) * C), i * CP) for i in range(3)]),
             padded_rows(params["fc"][0], 16, 32, [((0, 32), 0)]),
             padded_rows(params["lr0"][0], HID, 32, [((0, 24), 0)]),
             padded_rows(kc, HID, 96, [((0, Dx), 0)]),
             padded_rows(kc, HID, CV, [((Dx, Dx + C + 4), 0)])]
    bv = params["view_fc"][1] if "view_fc" in params else kg.new_zeros(C)

    def one(name):  # a one-output layer: weights as bf16 values, bias padded to 4
        w, b = params[name]
        return [rnd(w).reshape(-1), b.reshape(-1), b.new_zeros(3)]

    vecs = [bv.reshape(-1), bv.new_zeros(CP - C), params["global_fc"][1], *one("agg_w_fc"),
            params["fc"][1], params["lr0"][1], *one("sigma"), bc, *one("color1")]
    return torch.cat(mats), torch.cat(vecs)


def pack_head_weights(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two buffers (its ``Layout``). Matrices, bf16, each as
    ``padded_rows`` in nn.Linear's (out, in) layout: view_fc (if any) as
    CP rows (C padded to k16) over [dir 4]; global_fc over [img, var, avg],
    each third CP wide; fc; lr0 over [vox 8, agg 16]; color0 over [x 64,
    vox 8, agg 16] (96 wide) and over [feat C, dir 4] (C + 4 padded to
    k16). Vectors, float32: the view_fc bias (CP, zeros without view_fc),
    the global_fc bias, agg_w_fc's weights (bf16 values) and bias, the fc
    and lr0 biases, sigma's weights and bias, the color0 bias, color1's
    weights and bias; each single bias padded to 4."""
    mats, vecs = packed(params, _head_layout)
    return mats.to(torch.bfloat16), vecs


def fused_nerf_head(
    params: dict,
    vox: torch.Tensor,  # (B, P, 8)
    feat: torch.Tensor,  # (B, S, P, C) per-view features incl. RGB (last 3)
    dirs: torch.Tensor,  # (B, S, P, 4) ray-difference descriptors
) -> torch.Tensor:
    """Raw (rgb, sigma), (B, P, 4), for every sample: the bf16 tensor-core
    kernel on the card. CPU tensors take the plain version in float32, as
    the JAX package takes the flax head off the TPU."""
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
    if C not in CHANNELS:
        raise ValueError(f"{NAME}: channels {C} not in {CHANNELS}")
    max_views = _build.source_constant(NAME, "MAX_VIEWS")
    if not 2 <= S <= max_views:
        raise ValueError(f"{NAME}: the kernel takes 2 to {max_views} views, got {S}")
    if tuple(params["lr0"][0].shape) != (HID, 24):
        raise ValueError(f"{NAME}: the kernel takes a {HID}-wide head over 8+16 inputs")
    dev = feat.device
    mats, vecs = pack_head_weights(params)
    _build.check_inputs(NAME, dev, vecs=vecs, vox=vox, feat=feat, dirs=dirs)
    _build.check_inputs(NAME, dev, dtype=torch.bfloat16, mats=mats)
    out = torch.empty((B, P, 4), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "enerf_head_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(mats.data_ptr(), mats.numel(), vecs.data_ptr(), vecs.numel(), vox.data_ptr(),
                feat.data_ptr(), dirs.data_ptr(), out.data_ptr(), B, S, P, C,
                int("view_fc" in params), _build.sm_count(dev), _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
