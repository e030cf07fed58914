"""Kernel 6: trilinear sampling of a channels-last volume, zeros padding.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/tri_sample.py::
fused_tri_sample``; the CUDA source is ``csrc/tri_sample.cu``. The TPU
kernel takes row-banded (B, R, T) coordinate planes and (y, z) windows; a
direct gather needs neither, so here the samples are flat (B, P, 3).

As in JAX, ``compute_dtype`` sets the operands: bfloat16 (JAX's default,
which both MVSNeRF call sites use) rounds the volume and the x tap weights
to bf16 and each (y, z)-weighted tap row's partial to bf16 again, with
float32 sums; float32 runs the f32 instance. ``samples_per_ray`` tells the
kernel how the samples are ordered (ray by ray, that many each), so that
a warp takes neighbouring rays at one sample index; it never changes the
result.
"""

from __future__ import annotations

import ctypes
import math

import torch

from boostmvsnerfs_torch.ops import sampling
from boostmvsnerfs_torch.ops.cuda import _build
from boostmvsnerfs_torch.ops.cuda._tensor_cores import check_compute_dtype

NAME = "tri_sample"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# a warp's lanes: the kernel gives them 32 rays at one sample index
WARP = 32


def _check_samples_per_ray(samples_per_ray) -> None:
    if isinstance(samples_per_ray, bool) or not isinstance(samples_per_ray, int) \
            or samples_per_ray < 1:
        raise ValueError(f"{NAME}: samples_per_ray must be a positive int, got "
                         f"{samples_per_ray!r}")


def tri_sample_plain(vol: torch.Tensor, xyz: torch.Tensor, samples_per_ray: int = 1,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version: ``sampling.grid_sample_3d`` with zeros
    padding at ``compute_dtype`` (``samples_per_ray`` is the kernel's
    ordering hint, checked and unused)."""
    check_compute_dtype(NAME, compute_dtype)
    _check_samples_per_ray(samples_per_ray)
    return sampling.grid_sample_3d(vol, xyz, "zeros", compute_dtype)


def fused_tri_sample(
    vol: torch.Tensor,  # (B, D, H, W, C) float32, C a multiple of 4
    xyz: torch.Tensor,  # (B, P, 3) voxel coords (x->W, y->H, z->D), align-corners
    samples_per_ray: int = 1,  # samples ordered ray by ray, this many each
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Trilinear samples (B, P, C) in float32; taps outside the volume weigh
    0. On the card ``compute_dtype`` picks the instance: bfloat16 (the
    default, JAX's) or float32. CPU tensors take the plain version in
    float32, as the JAX model takes its XLA gather off the TPU."""
    check_compute_dtype(NAME, compute_dtype)
    _check_samples_per_ray(samples_per_ray)
    if vol.device.type == "cpu":
        return tri_sample_plain(vol, xyz)
    if vol.dim() != 5 or xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.shape[0] != vol.shape[0]:
        raise ValueError(
            f"{NAME}: expected vol (B,D,H,W,C) and xyz (B,P,3); got "
            f"{tuple(vol.shape)}, {tuple(xyz.shape)}"
        )
    B, D, H, W, C = vol.shape
    if C % 4:
        raise ValueError(f"{NAME}: channels must be a multiple of 4, got {C}")
    if D * H * W * C >= 2**31:
        raise ValueError(f"{NAME}: a volume of 2^31 elements or more per batch entry "
                         f"({tuple(vol.shape)}) exceeds the kernel's 32-bit offsets")
    P = xyz.shape[1]
    dev = vol.device
    _build.check_inputs(NAME, dev, vol=vol, xyz=xyz)
    out = torch.empty((B, P, C), dtype=torch.float32, device=dev)
    period = math.gcd(samples_per_ray, WARP)
    fn = _build.kernel_function(NAME, "tri_sample_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(vol.data_ptr(), xyz.data_ptr(), out.data_ptr(), B, D, H, W, C, P,
                period.bit_length() - 1, int(compute_dtype == torch.bfloat16),
                _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
