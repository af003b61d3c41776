"""NeRF-style sin/cos positional encoding (port of
holoscene_tpu/ops/embedder.py): [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...],
and its forward-mode derivative for the eikonal jacobians."""

from __future__ import annotations

import torch


def embedder_out_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x [..., D] -> [..., D*(1+2*multires)]."""
    if multires <= 0:
        return x
    feats = [x]
    for i in range(multires):
        freq = 2.0 ** i
        feats.append(torch.sin(x * freq))
        feats.append(torch.cos(x * freq))
    return torch.cat(feats, dim=-1)


def positional_encoding_jvp(x: torch.Tensor, tx: torch.Tensor,
                            multires: int) -> torch.Tensor:
    """Tangent of positional_encoding at x along tx (same shape as x, or
    with leading tangent axes that broadcast against it)."""
    if multires <= 0:
        return tx
    parts = [tx]
    for i in range(multires):
        freq = 2.0 ** i
        parts.append(torch.cos(x * freq) * (tx * freq))
        parts.append(-torch.sin(x * freq) * (tx * freq))
    return torch.cat(parts, dim=-1)
