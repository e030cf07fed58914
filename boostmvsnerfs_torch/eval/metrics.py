"""Image quality and depth metrics on tensors, computed on the tensors'
device (counterpart of ``boostmvsnerfs_tpu/eval/metrics.py``; the reference
relies on skimage, lib/evaluators/enerf.py:6-7).

SSIM follows skimage's ``structural_similarity`` defaults: 7x7 uniform
window over the valid region, K1=0.01, K2=0.03, sample covariance
normalisation (N/(N-1)), per-channel evaluation averaged for
multichannel inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def masked_psnr(pred, target, mask, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over masked pixels only (reference lib/evaluators/enerf.py:67-71
    evaluates with out-of-mask pixels excluded)."""
    mask = mask.float()
    if mask.dim() == pred.dim() - 1:
        mask = mask[..., None]
    diff2 = (pred - target) ** 2 * mask
    denom = torch.clamp(torch.sum(mask.expand(pred.shape)), min=1.0)
    return 10.0 * torch.log10(data_range**2 / (torch.sum(diff2) / denom))


def _uniform_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over each size x size window inside the image (valid windows:
    output H-size+1 x W-size+1), skimage's crop behaviour."""
    return F.avg_pool2d(img[None, None], size, stride=1)[0, 0]


def ssim_single(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
                win_size: int = 7) -> torch.Tensor:
    """SSIM of one channel (H, W), matching skimage's defaults."""
    a, b = a.float(), b.float()
    n = win_size * win_size
    cov_norm = n / (n - 1)
    ux, uy = _uniform_filter(a, win_size), _uniform_filter(b, win_size)
    uxx, uyy = _uniform_filter(a * a, win_size), _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1, C2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    return torch.mean(S)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Multichannel SSIM of (H, W[, C]) images: the mean of the channels'."""
    if pred.dim() == 2:
        return ssim_single(pred, target, data_range)
    return torch.stack([ssim_single(pred[..., c], target[..., c], data_range)
                        for c in range(pred.shape[-1])]).mean()


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """DTU depth metrics (reference lib/evaluators/enerf.py:96-103): mean
    absolute error and accuracy at 2mm / 10mm over valid (gt != 0)."""
    mask = gt != 0.0
    err = torch.abs(pred[mask] - gt[mask])
    return {"abs": float(err.mean()),
            "acc_2": float((err < 2.0).float().mean()),
            "acc_10": float((err < 10.0).float().mean())}
