"""LPIPS with the AlexNet backbone from converted weights (port of
holoscene_tpu/utils/lpips_jax.py; the metric of lpips.LPIPS(net='alex'),
v0.1 weights).

The `lpips` package and its pretrained weights are not installable in
hermetic environments, so the network is evaluated from a one-time weight
export (scripts/export_lpips_npz.py writes it where the package exists).
The file is read from $HOLOSCENE_LPIPS_NPZ or
~/.cache/holoscene/lpips_alex.npz, the paths the JAX package reads, so one
file serves both.

The network: inputs in [-1, 1] through the scaling layer (x - shift) /
scale; torchvision's AlexNet features with taps after relu1..relu5
(64 / 192 / 384 / 256 / 256 channels) and a 3x3 stride-2 max-pool before
taps 2 and 3; per tap, unit normalisation over channels, the squared
difference, the non-negative 1x1 linear weights, the spatial mean; the sum
over the taps. Convolutions run in float32 (lpips_from_npz switches TF32
off for a network on the card, as the runners do)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# lpips.ScalingLayer constants (lpips/lpips.py v0.1)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (out_ch, in_ch, kernel, stride, pad, maxpool_before)
_ALEX_CONVS = (
    (64, 3, 11, 4, 2, False),
    (192, 64, 5, 1, 2, True),
    (384, 192, 3, 1, 1, True),
    (256, 384, 3, 1, 1, False),
    (256, 256, 3, 1, 1, False),
)

DEFAULT_NPZ = os.path.join(os.path.expanduser("~"), ".cache", "holoscene",
                           "lpips_alex.npz")


def init_random_params(seed: int = 0) -> dict:
    """Random numpy weights with the lpips-alex shapes, drawn as the JAX
    module draws them (for tests and smoke paths; not a perceptual
    metric)."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    for i, (out_c, in_c, k, _s, _p, _mp) in enumerate(_ALEX_CONVS):
        params[f"conv{i}_w"] = rng.normal(
            0, 0.05, (out_c, in_c, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.01, (out_c,)).astype(np.float32)
        params[f"lin{i}_w"] = rng.uniform(0, 0.2, (out_c,)).astype(np.float32)
    return params


def load_lpips_npz(path: str) -> dict:
    """The weight export as numpy arrays, shapes checked."""
    with np.load(path) as z:
        params = {k: np.asarray(z[k], np.float32) for k in z.files}
    for i, (out_c, in_c, k, _s, _p, _mp) in enumerate(_ALEX_CONVS):
        if params[f"conv{i}_w"].shape != (out_c, in_c, k, k) \
                or params[f"lin{i}_w"].shape != (out_c,):
            raise ValueError(f"{path}: tap {i} has conv "
                             f"{params[f'conv{i}_w'].shape}, lin "
                             f"{params[f'lin{i}_w'].shape}")
    return params


def params_to_torch(params: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def _features(params: dict, x: torch.Tensor) -> list:
    """x [B, 3, H, W] in [-1, 1] -> the five tap activations."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    taps = []
    for i, (_o, _i, _k, s, p, mp) in enumerate(_ALEX_CONVS):
        if mp:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=s, padding=p))
        taps.append(x)
    return taps


def _unit_normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt((x * x).sum(1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_pair(params: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance (0-d tensor) between two [H, W, 3] images in [0, 1];
    params: tensors on the images' device."""
    fa = _features(params, a.permute(2, 0, 1)[None] * 2.0 - 1.0)
    fb = _features(params, b.permute(2, 0, 1)[None] * 2.0 - 1.0)
    total = a.new_zeros(())
    for i, (xa, xb) in enumerate(zip(fa, fb)):
        d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
        w = params[f"lin{i}_w"][None, :, None, None]
        total = total + (d * w).sum(1).mean()
    return total


def lpips_from_npz(path: str | None = None, device="cpu"):
    """lpips(a_hwc01, b_hwc01) -> float on `device`, or None when no weight
    file is found. Resolution order: path, $HOLOSCENE_LPIPS_NPZ,
    ~/.cache/holoscene/lpips_alex.npz."""
    path = path or os.environ.get("HOLOSCENE_LPIPS_NPZ") or DEFAULT_NPZ
    if not os.path.exists(path):
        return None
    params = params_to_torch(load_lpips_npz(path), device)
    if params["conv0_w"].is_cuda:
        # cuDNN would run the convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def fn(a, b):
        return float(lpips_pair(
            params, torch.as_tensor(np.asarray(a, np.float32), device=device),
            torch.as_tensor(np.asarray(b, np.float32), device=device)))

    return fn
