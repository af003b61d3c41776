"""Frozen plain copies of the port's Stage-4 modules (commit badb067): the
benchmark's reference for Gaussian-on-mesh training."""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """numpy / python / tensor -> tensor of `dtype` on `device` (a copy of
    holoscene_tpu_torch.as_tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
