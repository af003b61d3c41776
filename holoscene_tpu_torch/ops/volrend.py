"""Volume rendering integrator (port of holoscene_tpu/ops/volrend.py):
free energy = dist * density, T = exp(-cumsum(shifted free energy)),
weights = alpha * T, the last interval padded with 1e10."""

from __future__ import annotations

import torch


def ray_dists(z_vals: torch.Tensor, far_pad: float = 1e10) -> torch.Tensor:
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    return torch.cat([dists, torch.full_like(dists[..., :1], far_pad)], -1)


def volume_render_weights(z_vals: torch.Tensor, density: torch.Tensor):
    """z_vals, density [R, S] -> (weights, transmittance, dists), each
    [R, S]."""
    dists = ray_dists(z_vals)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[..., :1]),
                         free_energy[..., :-1]], -1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, -1))
    return alpha * transmittance, transmittance, dists


def occlusion_opacity(transmittance, dists, obj_density):
    """Per-object opacity [R, K] = sum_s (1 - exp(-dist sigma_k)) T_scene."""
    alpha = 1.0 - torch.exp(-(dists[..., None] * obj_density))
    return (alpha * transmittance[..., None]).sum(-2)


def composite(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """weights [R,S], values [R,S,C] -> [R,C]."""
    return (weights[..., None] * values).sum(-2)


def composite_depth(weights, z_vals, eps: float = 1e-8):
    acc = weights.sum(-1, keepdim=True)
    return (weights * z_vals).sum(-1, keepdim=True) / (acc + eps)
