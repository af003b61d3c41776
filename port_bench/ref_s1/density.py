# Frozen copy of holoscene_tpu_torch/ops/density.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s1, cut to
# the paths the benchmark's Stage-1 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""VolSDF Laplace density (port of holoscene_tpu/ops/density.py):
density(s) = (1/beta) (0.5 + 0.5 sign(s) expm1(-|s|/beta)),
beta = |beta_param| + beta_min."""

from __future__ import annotations

import torch


def laplace_beta(beta_param: torch.Tensor, beta_min: float = 1e-4):
    return beta_param.abs() + beta_min


def laplace_density(sdf: torch.Tensor, beta) -> torch.Tensor:
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf)
                    * torch.expm1(-sdf.abs() / beta))
