"""Image quality metrics: PSNR, SSIM, and the LPIPS slot (copy of
holoscene_tpu/utils/eval_rgb.py).

PSNR/SSIM are implemented directly on [0,1] HWC images (numpy, skimage-
compatible: the uniform 7x7 window matches skimage.structural_similarity
defaults with data_range=1). LPIPS comes from `lpips_fn`: the `lpips`
package with its pretrained weights, else the port's network
(utils/lpips.py) on converted weights; without either, `eval_rgb` reports
lpips=NaN with a warning, so NaNs in eval tables are never silent.
"""

from __future__ import annotations

import os

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


_LPIPS_CACHE: dict = {}


def lpips_fn(device="cpu"):
    """lpips(img1_hwc01, img2_hwc01) -> float, or None when no LPIPS
    backend is available. Resolution order (JAX lpips_fn's):

      1. the `lpips` package with its pretrained weights (on the CPU);
      2. utils/lpips.py on `device` from a converted weight file
         ($HOLOSCENE_LPIPS_NPZ or ~/.cache/holoscene/lpips_alex.npz,
         scripts/export_lpips_npz.py);
      3. None.

    The package's network is built once; the weight file is looked up on
    every call and its network cached by path and device."""
    if "package" not in _LPIPS_CACHE:
        try:
            import lpips as lpips_pkg
            import torch

            net = lpips_pkg.LPIPS(net="alex")

            def fn(a, b):
                ta, tb = (torch.from_numpy(np.asarray(x, np.float32)
                                           .transpose(2, 0, 1)[None] * 2 - 1)
                          for x in (a, b))
                with torch.no_grad():
                    return float(net(ta, tb).item())

            _LPIPS_CACHE["package"] = fn
        except Exception:
            _LPIPS_CACHE["package"] = None
    if _LPIPS_CACHE["package"] is not None:
        return _LPIPS_CACHE["package"]
    from holoscene_tpu_torch.utils.lpips import DEFAULT_NPZ, lpips_from_npz

    path = os.environ.get("HOLOSCENE_LPIPS_NPZ") or DEFAULT_NPZ
    key = (path, str(device))
    if key not in _LPIPS_CACHE:
        fn = lpips_from_npz(path, device)
        if fn is None:      # not cached: the file may appear later
            return None
        _LPIPS_CACHE[key] = fn
    return _LPIPS_CACHE[key]


def eval_rgb(pred: np.ndarray, gt: np.ndarray, device="cpu") -> dict:
    """Full metric dict for one image pair; LPIPS on `device` when it comes
    from the port's network. Without an LPIPS backend the warning goes
    through Python's default filter, which shows it once per call site."""
    out = {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt)}
    lp = lpips_fn(device)
    if lp is None:
        import warnings

        warnings.warn("LPIPS unavailable (lpips package or its weights "
                      "missing): reporting lpips=NaN in eval metrics",
                      stacklevel=2)
        out["lpips"] = float("nan")
    else:
        out["lpips"] = lp(pred, gt)
    return out
