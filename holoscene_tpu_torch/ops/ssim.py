"""Differentiable SSIM for the Stage-4 loss (port of
holoscene_tpu/ops/ssim.py: gaussian 11x11 window, k1=0.01, k2=0.03, valid
cropping). The blur runs through cuDNN on the card: the Stage-4 trainer turns
TF32 off so it stays float32 (see training/stage4.py)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_chw(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur; img [C, H, W] -> valid-cropped [C, H', W']."""
    k = kernel.shape[0]
    x = img[:, None]                     # [C, 1, H, W]
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1))
    x = F.conv2d(x, kernel.reshape(1, 1, 1, k))
    return x[:, 0]


def ssim_chw(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
             win_size: int = 11, k1: float = 0.01,
             k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images (the trainer's layout)."""
    kernel = torch.as_tensor(_gaussian_kernel(win_size), device=img1.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu1 = _blur_chw(img1, kernel)
    mu2 = _blur_chw(img2, kernel)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1 = _blur_chw(img1 * img1, kernel) - mu1_sq
    sigma2 = _blur_chw(img2 * img2, kernel) - mu2_sq
    sigma12 = _blur_chw(img1 * img2, kernel) - mu12

    s = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2)
    )
    return s.mean()


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over [H, W, C] images (same math as ssim_chw)."""
    return ssim_chw(img1.permute(2, 0, 1), img2.permute(2, 0, 1),
                    data_range, win_size, k1, k2)
