"""Image quality metrics: PSNR, SSIM, and the LPIPS slot (copy of
holoscene_tpu/utils/eval_rgb.py).

PSNR/SSIM are implemented directly on [0,1] HWC images (numpy, skimage-
compatible: the uniform 7x7 window matches skimage.structural_similarity
defaults with data_range=1). LPIPS needs a pretrained AlexNet backbone the
port has no access to: `eval_rgb` reports lpips=NaN with a warning, so NaNs
in eval tables are never silent.
"""

from __future__ import annotations

import numpy as np


def psnr(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0) -> float:
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable uniform filter over the first two axes ('valid'-interior,
    edge-replicated like scipy.ndimage uniform_filter default reflect)."""
    from scipy.ndimage import uniform_filter

    return uniform_filter(x, size=(size, size) + (0,) * (x.ndim - 2))


def ssim(
    img1: np.ndarray,
    img2: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean SSIM matching skimage.structural_similarity defaults
    (uniform window, channel-average)."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]

    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    ux = _uniform_filter(img1, win_size)
    uy = _uniform_filter(img2, win_size)
    uxx = _uniform_filter(img1 * img1, win_size)
    uyy = _uniform_filter(img2 * img2, win_size)
    uxy = _uniform_filter(img1 * img2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def eval_rgb(pred: np.ndarray, gt: np.ndarray) -> dict:
    """Full metric dict for one image pair. The warning goes through Python's
    default filter, which shows it once per call site."""
    import warnings

    warnings.warn("LPIPS unavailable: reporting lpips=NaN in eval metrics",
                  stacklevel=2)
    return {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt),
            "lpips": float("nan")}
