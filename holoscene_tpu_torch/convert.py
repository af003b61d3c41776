"""Converters between the JAX package's Gaussian-on-Mesh state and the
port's tensors. Inputs are numpy arrays (np.asarray of the JAX leaves), so
this module never imports jax; the tests use it to start both sides from
identical state."""

from __future__ import annotations

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor


def gom_params_from_jax(tree: dict, device: str | torch.device = "cpu",
                        requires_grad: bool = True) -> dict:
    """JAX GoM params {name: array} -> {name: float32 leaf tensor}, same
    keys and shapes."""
    dev = torch.device(device)
    return {k: as_tensor(np.asarray(v), dev).requires_grad_(requires_grad)
            for k, v in tree.items()}


def gom_static_from_jax(static: dict,
                        device: str | torch.device = "cpu") -> dict:
    """JAX GoM static dict -> the port's: array entries become float32
    tensors; instance_ranges and num_gaussians are copied."""
    dev = torch.device(device)
    out = {k: as_tensor(np.asarray(v), dev) for k, v in static.items()
           if k not in ("instance_ranges", "num_gaussians")}
    out["instance_ranges"] = [(int(lo), int(hi))
                              for lo, hi in static["instance_ranges"]]
    out["num_gaussians"] = int(static["num_gaussians"])
    return out


def params_to_numpy(params: dict) -> dict:
    """Tensors -> numpy arrays (the way back)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
