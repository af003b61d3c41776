"""HoloScene on PyTorch and CUDA: the port of `holoscene_tpu` to one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `holoscene_tpu/` stays the reference; every module here keeps
its counterpart's path and names (`holoscene_tpu_torch/ops/splat_flat.py` <->
`holoscene_tpu/ops/splat_flat.py`) and is parity-tested against it on the CPU
(tests/test_torch_*.py). This package imports torch and never jax; it reuses
the reference's jax-free host modules (config, datasets, mesh I/O, marching
tetrahedra, USDZ export, numpy PSNR/SSIM) instead of copying them.

Layer map (the Stage-4 Gaussian-on-Mesh training slice):
  ops/        projection + SH (gaussians), SSIM, flat tile binning and the
              K1/K2 tile-walk kernels (splat_flat), the image epilogue
              (splat), the mesh mask/depth rasterizer
  csrc/       hand-written CUDA for sm_90a (built by kernels.py on first use)
  models/     Gaussian-on-Mesh seeding, reparameterisations, render, loss
  training/   Stage4Runner and the exp_runner_gaussian CLI
  convert.py  JAX params/static (as numpy) <-> torch tensors
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.

    There is no silent CPU fallback: a run that asked for the card and got
    the CPU would report CPU numbers under a device's name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """numpy / python / tensor -> tensor of `dtype` on `device` (a copy for
    host input, so read-only numpy buffers are never aliased)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
