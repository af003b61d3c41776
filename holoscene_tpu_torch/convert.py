"""Converters between the JAX package's state (Gaussian-on-Mesh params and
static dict, Stage-1 and colour-field params) and the port's tensors. Inputs are numpy
arrays (np.asarray of the JAX leaves), so this module never imports jax;
the tests use it to start both sides from identical state."""

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


def stage1_params_from_jax(tree: dict, device: str | torch.device = "cpu"
                           ) -> dict:
    """JAX Stage-1 params (nested dicts of arrays: implicit / rendering /
    density) -> the port's state dict: paths joined with dots
    ("implicit.mlp.lin0.v"), float32 tensors of the same shapes."""
    dev = torch.device(device)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = as_tensor(np.asarray(v), dev)

    walk(tree, "")
    return out


def stage1_params_to_jax(state: dict) -> dict:
    """The way back: a state dict -> nested dicts of numpy arrays."""
    tree: dict = {}
    for key, v in state.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return tree


def color_field_params_from_jax(tree: dict,
                                device: str | torch.device = "cpu") -> dict:
    """JAX colour-field params ({grid, mlp: {lin{i}: {w, b}}}) ->
    ColorField's state dict ("grid", "mlp.lin0.w", ...)."""
    return stage1_params_from_jax(tree, device)


def color_field_params_to_jax(state: dict) -> dict:
    """ColorField's state dict -> JAX's nested numpy tree."""
    return stage1_params_to_jax(state)
