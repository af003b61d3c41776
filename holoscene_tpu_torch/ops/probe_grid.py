"""Baked dense probe grid for the sampler's SDF queries (port of
holoscene_tpu/ops/probe_grid.py): the coarse scene SDF evaluated on the
(res+1)^3 corner lattice of [-bound, bound]^3, each cell's 8 corners packed
into one row; the sampler's probes then read one 8-wide row per point. The
8-wide row gather stays torch indexing."""

from __future__ import annotations

from typing import Callable

import torch

from holoscene_tpu_torch.ops.sampler import linspace


def bake_probe_grid(sdf_fn: Callable, res: int, bound: float,
                    chunk: int = 1 << 18, device="cpu") -> torch.Tensor:
    """Block table [res^3, 8], corner order ix + 2 iy + 4 iz; sdf_fn is
    evaluated in chunks of `chunk` points (no gradient)."""
    n = res + 1
    axis = linspace(-bound, bound, n, device)
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    with torch.no_grad():
        vals = torch.cat([sdf_fn(pts[i:i + chunk])
                          for i in range(0, pts.shape[0], chunk)])
    v = vals.reshape(n, n, n)
    corners = [v[ix:ix + res, iy:iy + res, iz:iz + res]
               for iz in (0, 1) for iy in (0, 1) for ix in (0, 1)]
    return torch.stack(corners, -1).reshape(res ** 3, 8)


def probe_sdf_fn(table: torch.Tensor, res: int, bound: float) -> Callable:
    """pts [M, 3] -> proxy SDF [M]: one 8-wide row + trilinear combine;
    outside the box the clamped value is raised by the distance to it."""
    inv_cell = res / (2.0 * bound)

    def fn(pts: torch.Tensor) -> torch.Tensor:
        px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
        cx = px.clamp(-bound, bound)
        cy = py.clamp(-bound, bound)
        cz = pz.clamp(-bound, bound)
        oob2 = (px - cx) ** 2 + (py - cy) ** 2 + (pz - cz) ** 2
        ux = (cx + bound) * inv_cell
        uy = (cy + bound) * inv_cell
        uz = (cz + bound) * inv_cell
        ix = ux.to(torch.int32).clamp(0, res - 1)
        iy = uy.to(torch.int32).clamp(0, res - 1)
        iz = uz.to(torch.int32).clamp(0, res - 1)
        fx, fy, fz = ux - ix.to(ux.dtype), uy - iy.to(uy.dtype), uz - iz.to(uz.dtype)
        cid = ix.long() * (res * res) + iy.long() * res + iz.long()
        rt = table[cid].T
        gx0, gx1 = 1.0 - fx, fx
        gy0, gy1 = 1.0 - fy, fy
        gz0, gz1 = 1.0 - fz, fz
        val = (gz0 * (gy0 * (gx0 * rt[0] + gx1 * rt[1])
                      + gy1 * (gx0 * rt[2] + gx1 * rt[3]))
               + gz1 * (gy0 * (gx0 * rt[4] + gx1 * rt[5])
                        + gy1 * (gx0 * rt[6] + gx1 * rt[7])))
        return val + torch.sqrt(oob2 + 1e-20)

    return fn
