"""LPIPS perceptual distance, VGG variant (counterpart of
``boostmvsnerfs_tpu/eval/lpips.py``).

The lpips package's computation (net='vgg', reference
lib/evaluators/enerf.py:25): its input scaling, VGG16 relu1_2..relu5_3
activations, channel-wise unit normalisation, squared differences
projected through per-layer non-negative 1x1 heads, spatially averaged and
summed over layers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.eval.vgg import VGG16Features, vgg_state_dict_from_npz

# lpips 'vgg' scaling layer constants (lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
LIN_CHANNELS = (64, 128, 256, 512, 512)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance of image pairs (B, H, W, 3) in [-1, 1] -> (B,). Takes
    a ``VGG16Features`` state dict and the five heads' weights (C_l,).
    Runs on CUDA unless ``device`` says otherwise."""

    def __init__(self, vgg_state: dict, lin_weights, device=None):
        super().__init__()
        self.vgg = VGG16Features()
        self.vgg.load_state_dict(vgg_state, strict=True)
        for i, w in enumerate(lin_weights):
            self.register_buffer(f"lin{i}", torch.tensor(np.asarray(w, np.float32).reshape(-1)))
        self.register_buffer("shift", torch.tensor(_SHIFT))
        self.register_buffer("scale", torch.tensor(_SCALE))
        self.to(resolve_device(device))
        self.eval()

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.vgg((a - self.shift) / self.scale)
        fb = self.vgg((b - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
            total = total + torch.mean(torch.sum(d * getattr(self, f"lin{i}"), dim=-1),
                                       dim=(-1, -2))
        return total


def fixture_lpips(seed: int = 0, device=None) -> LPIPS:
    """LPIPS with deterministic stand-in weights: VGG convs from a seeded
    ``torch.Generator`` (LeCun normal, zero biases, as flax initialises
    them), heads U(0, 2/C) from a seeded numpy generator, as in JAX. The
    official weights cannot be fetched without network access, so values
    are NOT comparable to published LPIPS; the evaluator reports them as
    ``lpips_uncalibrated``. ``load_lpips`` takes converted weights."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in VGG16Features().state_dict().items():
        if k.endswith("weight"):
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            sd[k] = torch.randn(v.shape, generator=gen) / np.sqrt(fan_in)
        else:
            sd[k] = torch.zeros(v.shape)
    rng = np.random.default_rng(seed)
    lins = [rng.uniform(0.0, 2.0 / c, (c,)).astype(np.float32) for c in LIN_CHANNELS]
    return LPIPS(sd, lins, device)


def convert_lpips_weights(pth: str, out_path: str) -> dict:
    """The lpips package's VGG heads from a local file (its ``vgg.pth``,
    keys ``lin{i}.model.1.weight`` of shape (1, C, 1, 1)) -> the ``.npz``
    that JAX's ``convert_lpips_weights`` writes (``lin0`` ... ``lin4``, each
    (C,)). Imports no lpips and downloads nothing. Returns the arrays."""
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    arrays = {f"lin{i}": sd[f"lin{i}.model.1.weight"].numpy().reshape(-1)
              for i in range(len(LIN_CHANNELS))}
    for i, c in enumerate(LIN_CHANNELS):
        if arrays[f"lin{i}"].shape != (c,):
            raise ValueError(f"{pth}: lin{i} has {arrays[f'lin{i}'].size} channels, not {c}")
    np.savez(out_path, **arrays)
    return arrays


def load_lpips(vgg_npz: str, lin_npz: str, device=None) -> LPIPS:
    """LPIPS from the two ``.npz`` files the JAX package reads: VGG16
    weights (``conv{i}_kernel`` / ``conv{i}_bias``) and the heads
    (``lin0`` ... ``lin4``)."""
    data = np.load(lin_npz)
    return LPIPS(vgg_state_dict_from_npz(vgg_npz), [data[f"lin{i}"] for i in range(5)], device)
