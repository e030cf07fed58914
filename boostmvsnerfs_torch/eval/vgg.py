"""VGG16 feature extractor for LPIPS and the perceptual loss (counterpart
of ``boostmvsnerfs_tpu/eval/vgg.py``).

The torchvision VGG16 conv topology, channels-last in and out: the
activations after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3. Modules
``conv0`` ... ``conv12`` carry the JAX tree's names; pretrained weights
load from the same ``.npz`` the JAX package reads (``conv{i}_kernel`` HWIO,
``conv{i}_bias``), which ``convert_torchvision_weights`` writes from a local
file of torchvision's weights (``python -m
boostmvsnerfs_torch.convert_metric_weights``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.utils.port_weights import vgg_state_dict_from_jax

# VGG16 feature config: conv channels per layer, 'M' = maxpool
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512, "M"]
# the slices end after these conv layers (relu1_2 .. relu5_3)
SLICE_ENDS = (2, 4, 7, 10, 13)


class VGG16Features(nn.Module):
    """(B, H, W, 3) -> [relu1_2, relu2_2, relu3_3, relu4_3, relu5_3], each
    (B, h, w, C) channels-last."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, c in enumerate(v for v in VGG16_CFG if v != "M"):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, 3, padding=1))
            cin = c

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        outs, conv_i = [], 0
        for v in VGG16_CFG[:-1]:  # the last pool feeds no slice
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{conv_i}")(x))
            conv_i += 1
            if conv_i in SLICE_ENDS:
                outs.append(x.permute(0, 2, 3, 1))
        return outs


def vgg_state_dict_from_npz(npz_path: str) -> dict:
    """Converted torchvision weights (``conv{i}_kernel`` HWIO and
    ``conv{i}_bias``, the JAX package's ``load_vgg_params`` format) -> a
    ``VGG16Features`` state dict."""
    data = np.load(npz_path)
    n = sum(k.endswith("_kernel") for k in data.files)
    return vgg_state_dict_from_jax({"params": {
        f"conv{i}": {"kernel": data[f"conv{i}_kernel"], "bias": data[f"conv{i}_bias"]}
        for i in range(n)}})


def convert_torchvision_weights(pth: str, out_path: str) -> dict:
    """torchvision's VGG16 weights from a local file -> the ``.npz`` that
    JAX's ``convert_torchvision_weights`` writes: ``conv{i}_kernel`` (OIHW
    -> HWIO) and ``conv{i}_bias`` for the 13 convolutions in layer order.
    The file holds the ``features`` state dict (keys ``N.weight`` /
    ``N.bias``) or the whole model's (``features.N.*``, the classifier left
    out). Imports no torchvision and downloads nothing. Returns the
    arrays."""
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    layers = sorted(int(k[len(prefix):].split(".")[0]) for k in sd
                    if k.startswith(prefix) and k.endswith(".weight")
                    and k[len(prefix):].split(".")[0].isdigit())
    n_convs = sum(v != "M" for v in VGG16_CFG)
    if len(layers) != n_convs:
        raise ValueError(f"{pth}: {len(layers)} convolutions, a VGG16 has {n_convs}")
    arrays = {}
    for i, n in enumerate(layers):
        arrays[f"conv{i}_kernel"] = sd[f"{prefix}{n}.weight"].numpy().transpose(2, 3, 1, 0)
        arrays[f"conv{i}_bias"] = sd[f"{prefix}{n}.bias"].numpy()
    np.savez(out_path, **arrays)
    return arrays


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB, channels-last -> ImageNet-normalized (reference
    lib/train/losses/vgg_perceptual_loss.py:12-14, 24-25)."""
    mean = img01.new_tensor(IMAGENET_MEAN)
    std = img01.new_tensor(IMAGENET_STD)
    return (img01 - mean) / std


def load_vgg(npz_path: str, device=None) -> VGG16Features:
    """``VGG16Features`` with the converted torchvision weights of
    ``npz_path`` (``vgg_state_dict_from_npz``), frozen, in eval mode, on
    CUDA unless ``device`` says otherwise."""
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_npz(npz_path))
    return vgg.to(resolve_device(device)).eval().requires_grad_(False)


def perceptual_loss_fn(vgg: VGG16Features, n_blocks: int = 4):
    """``fn(pred01, tar01) -> scalar``: the mean L1 distance over the first
    ``n_blocks`` feature slices of the ImageNet-normalized images (B, H, W, 3)
    (reference vgg_perceptual_loss.py:27-43, feature_layers=[0, 1, 2, 3]).
    Gradients flow to ``pred01``."""

    def fn(pred: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
        fp = vgg(normalize_imagenet(pred))
        ft = vgg(normalize_imagenet(tar))
        return sum(torch.mean(torch.abs(a - b)) for a, b in list(zip(fp, ft))[:n_blocks])

    return fn
