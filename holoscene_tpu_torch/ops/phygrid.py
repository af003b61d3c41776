"""Dense importance grid for physics-guided sampling (port of
holoscene_tpu/ops/phygrid.py; reference model/PhyGrid.py): a res^3 scalar
grid over [-bound, bound]^3 with trilinear sampling, scatter-max updates
from point observations and box smoothing. A grid is a dict {"values"
[res, res, res], "bound"}, as in the JAX module."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_dense_grid(resolution: int = 256, bound: float = 1.0,
                    device="cpu") -> dict:
    return {"values": torch.zeros((resolution,) * 3, dtype=torch.float32,
                                  device=device),
            "bound": bound}


def _to_grid_coords(pts, bound: float, res: int):
    return (pts + bound) / (2 * bound) * (res - 1)


def grid_sample(grid: dict, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation at world points [N, 3] -> [N]. The upper
    corner of a point clamped to the last cell is clamped into the grid, as
    JAX's gather clamps it (its weight is zero)."""
    values = grid["values"]
    res = values.shape[0]
    g = torch.clamp(_to_grid_coords(pts, grid["bound"], res), 0.0,
                    res - 1 - 1e-6)
    i0 = torch.floor(g).to(torch.int64)
    frac = g - i0
    out = torch.zeros(pts.shape[0], dtype=values.dtype, device=values.device)
    for corner in range(8):
        off = torch.tensor([(corner >> k) & 1 for k in range(3)],
                           device=pts.device)
        idx = torch.clamp(i0 + off[None, :], max=res - 1)
        w = torch.where(off[None, :] == 1, frac, 1.0 - frac).prod(-1)
        out = out + w * values[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


def grid_splat_max(grid: dict, pts: torch.Tensor, vals: torch.Tensor) -> dict:
    """Scatter-max point values into their nearest cells; a cell hit
    several times keeps the largest value and its own if larger."""
    values = grid["values"]
    res = values.shape[0]
    idx = torch.clamp(torch.round(_to_grid_coords(pts, grid["bound"], res))
                      .to(torch.int64), 0, res - 1)
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    values = values.reshape(-1).scatter_reduce(
        0, flat, vals.to(values.dtype), "amax", include_self=True)
    return {**grid, "values": values.reshape((res,) * 3)}


def grid_smooth(grid: dict, kernel_size: int = 3) -> dict:
    """Box smoothing with zero padding (lax.conv_general_dilated's)."""
    v = grid["values"][None, None]
    k = torch.full((1, 1) + (kernel_size,) * 3, 1.0 / kernel_size ** 3,
                   dtype=v.dtype, device=v.device)
    return {**grid, "values": F.conv3d(v, k, padding=kernel_size // 2)[0, 0]}
